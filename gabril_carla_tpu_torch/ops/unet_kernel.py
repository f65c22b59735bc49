"""The frozen gaze UNet's forward at eval as hand-written CUDA kernels:
build, binding, wrapper and plain version.

``csrc/unet.cu`` runs models/unet.py's UNet in bf16 (bf16 products with
float32 sums, GroupNorm statistics and normalisation in float32, eps 1e-6,
min(8, C) groups, relu after each norm) with activations NHWC in bf16 and
each GroupNorm folded into the convs on either side of it: a conv stores
its bf16 output before the norm, with per-tile statistics; ``finalize``
turns them into per-(sample, channel) scale and shift; the next conv (or
transposed conv, or the output conv) applies norm and relu as it loads,
and the 2x2 max pool and the decoder's concatenation too. It replaces no
TPU kernel (the JAX package left the UNet to XLA). It is compiled with
nvcc for sm_90a at first use (ops/nvcc.py) and bound with ctypes, as the
render kernel is.

``unet_forward(model, params, obs)`` is the entry: for CUDA tensors it
launches the kernels (or raises), for CPU tensors it runs the same chain
with ``PlainOps``, the kernels' arithmetic in plain PyTorch (NHWC, bf16
storage, float32 statistics, the norm on load). Rounding to bf16 falls
where the module's forward rounds: each conv's output, and each conv's
input as it casts it; only the order of the sums differs. Weights come
from ``params`` on every call; the kernels take a ring of at most 8
channels (the gaze configs' frame stack). ``unet_kernel.launches`` counts
the kernels' launches: 41 a forward (18 conv3x3, 18 finalize, 4
transposed, 1 output).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models.unet import GN_EPS
from . import nvcc

SOURCE = nvcc.CSRC / "unet.cu"
RING, NORM, POOL, RAW = 0, 1, 2, 3  # source A's load in csrc/unet.cu
GROUPS = 8
ENCODER = ("e1", "e2", "e3", "e4", "bott")
DECODER = (("up4", "d4"), ("up3", "d3"), ("up2", "d2"), ("up1", "d1"))
LAUNCHES_PER_FORWARD = 41


def build():
    """Compile csrc/unet.cu (ops/nvcc.py build)."""
    return nvcc.build(SOURCE)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    """A parameter as the kernels read it: contiguous float32 on ``device``."""
    if t.device != device:
        raise ValueError(f"unet kernels: a parameter on {t.device}, the activations on {device}")
    return t.to(torch.float32).contiguous()


class UnetKernel:
    """ctypes binding of csrc/unet.cu plus its launch count."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def load(self):
        if self._lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            i, p = ctypes.c_int, ctypes.c_void_p
            lib.unet_conv3x3_tiles.argtypes = [i] * 6
            lib.unet_conv3x3.argtypes = [i] * 4 + [p] * 8 + [i] * 6 + [p]
            lib.unet_gn_finalize.argtypes = [p, i, i, p, p, ctypes.c_float, p, i, p]
            lib.unet_conv_t.argtypes = [i, i] + [p] * 5 + [i] * 4 + [p]
            lib.unet_out1x1.argtypes = [p] * 5 + [i] * 4 + [p]
            for fn in (lib.unet_conv3x3_tiles, lib.unet_conv3x3, lib.unet_gn_finalize, lib.unet_conv_t,
                       lib.unet_out1x1):
                fn.restype = ctypes.c_int
            lib.unet_error_string.argtypes = [ctypes.c_int]
            lib.unet_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _done(self, what: str, err: int):
        if err != 0:
            raise RuntimeError(f"unet kernel {what} failed: {self._lib.unet_error_string(err).decode()}")
        self.launches += 1

    @staticmethod
    def _stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def conv3x3(self, a, ss_a, mode: int, skip, ss_skip, weight, bias):
        """3x3 conv (padding 1) of source ``a`` loaded by ``mode`` (the
        float32 ring, a normed or pooled bf16 activation, or the raw bf16
        upsampled half beside the normed ``skip``) -> (bf16 [B, H, W, CO]
        before its norm, float32 partials [B, tiles, 8, 3])."""
        lib = self.load()
        b, sh, sw, ca = a.shape
        h, w = (sh // 2, sw // 2) if mode == POOL else (sh, sw)
        cb = 0 if skip is None else skip.shape[3]
        co, cin = weight.shape[:2]
        if cin != ca + cb or (skip is not None and tuple(skip.shape) != (b, h, w, cb)):
            raise ValueError(f"unet conv3x3: sources {tuple(a.shape)} + "
                             f"{None if skip is None else tuple(skip.shape)} do not fit weight "
                             f"{tuple(weight.shape)}")
        tiles = lib.unet_conv3x3_tiles(mode, ca, cb, co, h, w)
        if tiles < 0:
            raise ValueError(f"unet conv3x3: no kernel for mode {mode}, channels {ca} + {cb} -> {co}")
        out = torch.empty((b, h, w, co), dtype=torch.bfloat16, device=a.device)
        part = torch.empty((b, tiles, GROUPS, 3), dtype=torch.float32, device=a.device)
        wt, bs = _f32(weight, out.device), _f32(bias, out.device)
        err = lib.unet_conv3x3(mode, ca, cb, co, a.data_ptr(), _ptr(ss_a), _ptr(skip), _ptr(ss_skip),
                               wt.data_ptr(), bs.data_ptr(), out.data_ptr(), part.data_ptr(), b, h, w,
                               sh, sw, cin, self._stream(a))
        self._done("conv3x3", err)
        return out, part

    def finalize(self, part, gamma, beta):
        """Partials [B, tiles, 8, 3] -> float32 (scale, shift) [B, C, 2]."""
        lib = self.load()
        b, tiles = part.shape[:2]
        c = gamma.shape[0]
        ss = torch.empty((b, c, 2), dtype=torch.float32, device=part.device)
        g, bt = _f32(gamma, ss.device), _f32(beta, ss.device)
        err = lib.unet_gn_finalize(part.data_ptr(), tiles, c, g.data_ptr(), bt.data_ptr(), GN_EPS,
                                   ss.data_ptr(), b, self._stream(part))
        self._done("finalize", err)
        return ss

    def conv_t(self, x, ss, weight, bias, pad_h: int):
        """2x2 stride-2 transposed conv of normed ``x`` -> bf16 [B, 2H + pad_h, 2W, CO]."""
        lib = self.load()
        b, h, w, ci = x.shape
        co = weight.shape[1]
        out = torch.empty((b, 2 * h + pad_h, 2 * w, co), dtype=torch.bfloat16, device=x.device)
        wt, bs = _f32(weight, out.device), _f32(bias, out.device)
        err = lib.unet_conv_t(ci, co, x.data_ptr(), ss.data_ptr(), wt.data_ptr(), bs.data_ptr(),
                              out.data_ptr(), b, h, w, pad_h, self._stream(x))
        self._done("conv_t", err)
        return out

    def out1x1(self, x, ss, weight, bias):
        """1x1 conv of normed ``x`` -> bf16 [B, H, W, CO]."""
        lib = self.load()
        b, h, w, ci = x.shape
        co = weight.shape[0]
        out = torch.empty((b, h, w, co), dtype=torch.bfloat16, device=x.device)
        wt, bs = _f32(weight, out.device), _f32(bias, out.device)
        err = lib.unet_out1x1(x.data_ptr(), ss.data_ptr(), wt.data_ptr(), bs.data_ptr(), out.data_ptr(),
                              b, h * w, ci, co, self._stream(x))
        self._done("out1x1", err)
        return out


unet_kernel = UnetKernel()


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _bf16_f32(t):
    """``t`` rounded to bf16, in float32 (the kernels' weights and biases)."""
    return t.to(torch.bfloat16).to(torch.float32)


class PlainOps:
    """The kernels' functions in plain PyTorch, one method each. Its
    partials hold one tile a sample."""

    @staticmethod
    def normed(x, ss):
        """relu(x * scale + shift) in float32, NHWC."""
        return torch.relu(x.float() * ss[:, None, None, :, 0] + ss[:, None, None, :, 1])

    def load(self, a, ss, mode: int):
        if mode == RING:
            return a.to(torch.bfloat16)
        if mode == RAW:
            return a
        y = self.normed(a, ss)
        if mode == POOL:
            y = _nhwc(F.max_pool2d(_nchw(y), 2))
        return y.to(torch.bfloat16)

    def conv3x3(self, a, ss_a, mode: int, skip, ss_skip, weight, bias):
        x = self.load(a, ss_a, mode)
        if skip is not None:
            x = torch.cat([x, self.load(skip, ss_skip, NORM)], -1)
        y = F.conv2d(_nchw(x).float(), _bf16_f32(weight), padding=1) + _bf16_f32(bias)[:, None, None]
        y = _nhwc(y.to(torch.bfloat16))
        b, h, w, c = y.shape
        v = y.float().reshape(b, h * w, GROUPS, c // GROUPS)
        mean = v.mean((1, 3))
        m2 = ((v - mean[:, None, :, None]) ** 2).sum((1, 3))
        n = torch.full_like(mean, h * w * c // GROUPS)
        return y, torch.stack([n, mean, m2], -1)[:, None]

    @staticmethod
    def finalize(part, gamma, beta):
        n, mean, m2 = part[:, 0].unbind(-1)
        for t in range(1, part.shape[1]):  # Chan's merge, in tile order
            nb, mb, m2b = part[:, t].unbind(-1)
            d, nab = mb - mean, n + nb
            mean = mean + d * (nb / nab)
            m2 = m2 + m2b + d * d * (n * nb / nab)
            n = nab
        rstd = torch.rsqrt((m2 / n).clamp_min(0.0) + GN_EPS)
        c = gamma.shape[0]
        cpg = c // GROUPS
        scale = gamma.float() * rstd.repeat_interleave(cpg, 1)
        shift = beta.float() - mean.repeat_interleave(cpg, 1) * scale
        return torch.stack([scale, shift], -1)

    def conv_t(self, x, ss, weight, bias, pad_h: int):
        y = F.conv_transpose2d(_nchw(self.load(x, ss, NORM)).float(), _bf16_f32(weight), stride=2,
                               output_padding=(pad_h, 0))
        return _nhwc((y + _bf16_f32(bias)[:, None, None]).to(torch.bfloat16))

    def out1x1(self, x, ss, weight, bias):
        y = F.conv2d(_nchw(self.load(x, ss, NORM)).float(), _bf16_f32(weight)) + _bf16_f32(bias)[:, None, None]
        return _nhwc(y.to(torch.bfloat16))


def _output_padding(model, name: str) -> int:
    oph, opw = getattr(model, name).output_padding
    if opw != 0:
        raise ValueError(f"unet kernels: {name} pads its output's width ({opw}); only rows are padded")
    return int(oph)


def unet_forward(model, params: dict, obs: torch.Tensor, ops=None) -> torch.Tensor:
    """models/unet.py's UNet (``model``, for its layout) in bf16 on
    ``params`` (its state dict's names): obs [B, H, W, S] NHWC -> bf16
    [B, H, W, C_out], unclamped. ``ops``: the kernels for CUDA tensors and
    the plain version for CPU tensors unless given."""
    if ops is None:
        if obs.device.type == "cuda":
            ops = unet_kernel
        elif obs.device.type == "cpu":
            ops = PlainOps()
        else:
            raise ValueError(f"unet kernels: no kernel for device {obs.device}")
    p = params
    a, ss, mode = obs.to(torch.float32).contiguous(), None, RING
    skips = []
    for name in ENCODER:
        for k in range(2):
            y, part = ops.conv3x3(a, ss, mode, None, None, p[f"{name}.convs.{k}.weight"],
                                  p[f"{name}.convs.{k}.bias"])
            ss = ops.finalize(part, p[f"{name}.norms.{k}.weight"], p[f"{name}.norms.{k}.bias"])
            a, mode = y, NORM
        skips.append((a, ss))
        mode = POOL
    x, ss = skips.pop()
    for up, name in DECODER:
        u = ops.conv_t(x, ss, p[f"{up}.weight"], p[f"{up}.bias"], _output_padding(model, up))
        skip, ss_skip = skips.pop()
        a, src, ss_a = u, RAW, None
        for k in range(2):
            y, part = ops.conv3x3(a, ss_a, src, skip, ss_skip, p[f"{name}.convs.{k}.weight"],
                                  p[f"{name}.convs.{k}.bias"])
            ss_a = ops.finalize(part, p[f"{name}.norms.{k}.weight"], p[f"{name}.norms.{k}.bias"])
            a, src, skip, ss_skip = y, NORM, None, None
        x, ss = a, ss_a
    return ops.out1x1(x, ss, p["out.weight"], p["out.bias"])
