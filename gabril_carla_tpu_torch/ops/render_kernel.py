"""The camera render kernel: build, binding, wrapper and plain version.

``csrc/render.cu`` is the CUDA port of the TPU kernel
gabril_carla_tpu/ops/pallas_raster.py: _render_kernel. It is compiled with
nvcc for sm_90a into a shared library with a plain C interface at first use
(``build``), into ``gabril_carla_tpu_torch/_build/``, and loaded with ctypes.

``render_from_operands`` is the one entry: for CUDA tensors it launches the
kernel (or raises), for CPU tensors it runs ``render_from_operands_plain``,
the same function in plain PyTorch. ``render_kernel.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..env.constants import LANE_WIDTH

H, W = 180, 320
N_CAM = 18
ROW_COLS = 8
MAX_ROWS = 160  # ROUTE_VIEW route rows + 32 scenario-flow rows
MAX_BOXES = 32
ROUTE_VIEW = 128  # route points visible (1 m spacing; camera depth caps at 120 m)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "render.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# camera and shading constants of raster.py / pallas_raster.py (csrc/render.cu
# holds the same values)
FOV_DEG = 60.0
FX = (W / 2) / math.tan(math.radians(FOV_DEG) / 2)
CX, CY = (W - 1) / 2.0, (H - 1) / 2.0
CAM_Z = 1.6  # m above ground
MAX_DEPTH = 120.0
SKY, GRASS, ROAD, MARK = 0.62, 0.42, 0.24, 0.85


def build() -> tuple[Path, str]:
    """Compile csrc/render.cu with nvcc unless a library built from the same
    source and flags exists. Returns (library path, compiler output; empty
    when nothing was compiled)."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"librender_{tag}.so"
    if lib.exists():
        return lib, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


class RenderKernel:
    """ctypes binding of csrc/render.cu plus its launch count."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def load(self):
        if self._lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.render_frames.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.render_frames.restype = ctypes.c_int
            lib.render_error_string.argtypes = [ctypes.c_int]
            lib.render_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, cam_scalars, route_cols, boxes) -> torch.Tensor:
        lib = self.load()
        b = cam_scalars.shape[0]
        out = torch.empty((b, H, W), dtype=torch.float32, device=cam_scalars.device)
        stream = torch.cuda.current_stream(cam_scalars.device).cuda_stream
        err = lib.render_frames(cam_scalars.data_ptr(), route_cols.data_ptr(), boxes.data_ptr(),
                                out.data_ptr(), b, route_cols.shape[1], boxes.shape[1],
                                ROUTE_VIEW, stream)
        if err != 0:
            raise RuntimeError(f"render kernel launch failed: {lib.render_error_string(err).decode()}")
        self.launches += 1
        return out


render_kernel = RenderKernel()


def _check(cam_scalars, route_cols, boxes):
    b = cam_scalars.shape[0]
    if (cam_scalars.shape != (b, N_CAM) or route_cols.dim() != 3 or boxes.dim() != 3
            or route_cols.shape[0] != b or boxes.shape[0] != b
            or route_cols.shape[2] != ROW_COLS or boxes.shape[2] != ROW_COLS
            or not 1 <= route_cols.shape[1] <= MAX_ROWS or boxes.shape[1] > MAX_BOXES):
        raise ValueError(f"render operands: want cam [B, {N_CAM}], rows [B, <={MAX_ROWS}, 8], "
                         f"boxes [B, <={MAX_BOXES}, 8]; got {tuple(cam_scalars.shape)}, "
                         f"{tuple(route_cols.shape)}, {tuple(boxes.shape)}")
    for t in (cam_scalars, route_cols, boxes):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("render operands must be contiguous float32")
        if t.device != cam_scalars.device:
            raise ValueError("render operands must share one device")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError("render operands on the card must be 16-byte aligned (float4 loads)")


def render_from_operands(cam_scalars, route_cols, boxes) -> torch.Tensor:
    """cam_scalars [B, 18], route_cols [B, R, 8], boxes [B, K, 8] -> frames
    [B, 180, 320] in [0, 1]: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check(cam_scalars, route_cols, boxes)
    dev = cam_scalars.device.type
    if dev == "cuda":
        return render_kernel(cam_scalars, route_cols, boxes)
    if dev == "cpu":
        return render_from_operands_plain(cam_scalars, route_cols, boxes)
    raise ValueError(f"render: no kernel for device {cam_scalars.device}")


def _clamp(x, lo, hi):
    return x.clamp_min(lo).clamp_max(hi)


def render_from_operands_plain(cam_scalars, route_cols, boxes) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a full argmin over every row
    for each ground pixel, then the min-depth composite over every box."""
    b = cam_scalars.shape[0]
    dev = cam_scalars.device
    f32 = dict(dtype=torch.float32, device=dev)
    c = [cam_scalars[:, i, None, None] for i in range(10)]
    fwd_x, fwd_y, rgt_x, rgt_y, cloud, start_s, precip, fog, bright, wet = c

    v = torch.arange(H, **f32)[:, None]
    u = torch.arange(W, **f32)[None, :]
    dv = (v - CY).clamp_min(1e-3)
    z = _clamp(torch.tensor(CAM_Z * FX, **f32) / dv, 0.0, MAX_DEPTH)  # [H, 1]
    on_ground = ((v - CY) > 0.5) & (z < MAX_DEPTH)
    vis = MAX_DEPTH * (1.0 - 0.85 * fog)
    sky_col = SKY - 0.15 * cloud
    sky = (sky_col + 0.12 * (v / torch.tensor(float(H), **f32))).expand(b, H, W)

    # terrain, on the ground rows only (a static band of image rows)
    g_rows = on_ground[:, 0].nonzero()[:, 0]
    r0, r1 = int(g_rows[0]), int(g_rows[-1]) + 1
    zg = z[r0:r1]
    x = (u - CX) / torch.tensor(FX, **f32) * zg  # [h, W]
    gx = zg * fwd_x + x * rgt_x  # [B, h, W]
    gy = zg * fwd_y + x * rgt_y
    cols = route_cols
    t = (gx[..., None] * cols[:, None, None, :, 0] + gy[..., None] * cols[:, None, None, :, 1]
         + cols[:, None, None, :, 2])  # [B, h, W, R]
    t_min, idx = t.min(-1)  # first minimum, as the kernel's strict '<'
    sel = torch.gather(cols, 1, idx.reshape(b, -1, 1).expand(-1, -1, ROW_COLS)).reshape(
        idx.shape + (ROW_COLS,))
    sel = torch.where((t_min < 1e30)[..., None], sel, 0.0)
    bdx, bdy, be3, bj = sel[..., 3], sel[..., 4], sel[..., 5], sel[..., 6]
    lat = bdy * gx - bdx * gy + be3
    near_s = start_s + bj
    is_route = bj < float(ROUTE_VIEW)
    hi = torch.where(is_route, 1.5 * LANE_WIDTH + 0.3, 0.5 * LANE_WIDTH + 0.3)
    on_road = (lat > -0.5 * LANE_WIDTH - 0.3) & (lat < hi)
    dash = torch.remainder(near_s, 4.0) < 2.0  # floor mod, as jnp.mod
    centre = ((lat - 0.5 * LANE_WIDTH).abs() < 0.12) & dash & is_route
    edge = (((lat + 0.5 * LANE_WIDTH).abs() < 0.15)
            | ((lat - 1.5 * LANE_WIDTH).abs() < 0.15)) & is_route
    road_col = ROAD * (1.0 - 0.30 * wet)
    terrain = torch.where(on_road, road_col, torch.tensor(GRASS, **f32))
    terrain = torch.where(centre | edge, torch.tensor(MARK, **f32), terrain)
    fade_coef = 0.25 + 0.75 * fog
    fade = _clamp(zg / vis, 0.0, 1.0) * fade_coef
    terrain = terrain * (1.0 - fade) + sky_col * fade
    img = sky.clone()
    img[:, r0:r1] = torch.where(on_ground[r0:r1], terrain, sky[:, r0:r1])

    # min-depth composite over the box list (first of equal depths wins)
    bx = boxes[:, :, None, None, :]  # [B, K, 1, 1, 8]
    inside = ((u >= bx[..., 0]) & (u <= bx[..., 1]) & (v >= bx[..., 2]) & (v <= bx[..., 3])
              & (bx[..., 6] > 0.5))  # [B, K, H, W]
    depth = torch.where(inside, bx[..., 4], torch.tensor(1e30, **f32))
    best_d, best = depth.min(1)  # [B, H, W]
    best_c = torch.gather(boxes[..., 5], 1, best.reshape(b, -1)).reshape(best.shape)
    shade = 1.0 - _clamp(best_d / MAX_DEPTH, 0.0, 0.6)
    afog = _clamp(best_d / vis, 0.0, 1.0) * (0.8 * fog)
    img = torch.where(best_d < 1e29, best_c * shade * (1.0 - afog) + sky_col * afog, img)
    img = img * (1.0 - 0.2 * precip) + 0.5 * (0.2 * precip)
    img = img * bright
    return _clamp(img, 0.0, 1.0)
