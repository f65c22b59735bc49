"""The frozen gaze UNet's forward as CUDA kernels (ops/unet_kernel.py,
csrc/unet.cu) and the dispatch of ``make_gaze_predictor_apply``.

On the CPU: the kernels' plain version against models/unet.py's forward in
bf16 on the same weights, at a small size and at 180x320, where e4's max
pool floors 45 rows to 22 and up3 writes its output-padding row; and the
dispatch, which leaves the AutoEncoder, a float32 UNet and CPU tensors on
the module's forward without a launch. On the card (marker ``gpu``, skipped
without CUDA; this file imports neither JAX nor the JAX package):

    python -m pytest --noconftest -m gpu tests/test_torch_unet_kernel.py -q

the kernels against the plain version at B in {1, 3, 64}, against the
float32 UNet, their launches a forward, and two identical calls bitwise.

The bar. Kernels, plain version and module round to bf16 at the same
places (each conv's output, each conv's input); only the order of float32
sums differs, which flips a rounding tie by one bf16 unit (u = 2^-8) here
and there, carried through 18 norms. Each gap is a relative L2 norm held
to ``BAR`` = 8u, tests/test_torch_heat_bf16.py's forward bar across 27
bf16 layers; measured 1.1-4.6u between the plain version and the module
(three seeds, both sizes). Against the float32 UNet the kernels may be no
further than ``F32_RATIO`` times the module's bf16 forward on the same
frames: these synthetic frames put that forward 0.027-0.077 from float32
(the benchmark's rendered ones 0.021-0.059, PERF.md's ``heat_err``), and
the plain version's gap came within 0.5% of it.
"""

import numpy as np
import pytest
import torch
from torch.func import functional_call

from gabril_carla_tpu_torch.models.encoder import AutoEncoder
from gabril_carla_tpu_torch.models.unet import UNet
from gabril_carla_tpu_torch.ops import unet_kernel as UK
from gabril_carla_tpu_torch.train.gaze_predictor import make_gaze_predictor_apply

U = 2.0 ** -8
BAR = 8 * U
F32_RATIO = 1.1
SMALL = (20, 32)  # the smallest size whose levels fit up3's padding row: 20 -> 10 -> 5 -> 2 -> 1
FULL = (180, 320)


def unet_params(model, seed: int = 0) -> dict:
    """Float32 weights drawn with numpy: a conv's N(0, 2 / fan-in) (the
    output conv's at a tenth), a norm's scale 1 + N(0, 0.01), biases
    N(0, 1e-4), as the benchmark draws them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in model.state_dict().items():
        x = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if name.endswith("weight") and v.dim() >= 2:
            x *= np.sqrt(2.0 / np.prod(v.shape[1:])) * (0.1 if name.startswith("out.") else 1.0)
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x *= 0.01
        out[name] = torch.from_numpy(x)
    return out


def frames(b: int, h: int, w: int, seed: int = 0) -> torch.Tensor:
    """[B, H, W, 2] float32 frames in [0, 1]: smooth shading, a dark band
    and pixel noise, the second frame shifted by a pixel."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((b, h, w, 2), np.float32)
    for i in range(b):
        a, c, d = rng.uniform(0.2, 0.8, 3)
        base = a + 0.2 * np.sin(x / w * 6.0 * c + y / h * 3.0 * d)
        base = np.where(np.abs(y - h * c) < h / 10, 0.1, base)
        for s in range(2):
            out[i, :, :, s] = np.clip(np.roll(base, s, 1) + 0.03 * rng.standard_normal((h, w)), 0.0, 1.0)
    return torch.from_numpy(out)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def module_forward(model, params, obs):
    return functional_call(model, params, (obs.permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("size", [SMALL, FULL], ids=["20x32", "180x320"])
def test_plain_version_matches_module(size):
    """The plain version (NHWC, bf16 storage, float32 statistics, norm on
    load) against UNet.forward in bf16 on the same weights."""
    torch.manual_seed(0)
    b = 3 if size == SMALL else 1
    model = UNet(2, 1, dtype=torch.bfloat16)
    params = unet_params(model)
    obs = frames(b, *size)
    got = UK.unet_forward(model, params, obs)
    want = module_forward(model, params, obs)
    assert got.shape == want.shape == (b, *size, 1) and got.dtype == want.dtype == torch.bfloat16
    assert rel(got, want) <= BAR


def test_plain_version_floors_and_pads():
    """At 180x320 the plain layers give the module's sizes: e4 pools 45
    rows to 22, and up3's output-padding row 44 holds its bias alone."""
    model = UNet(2, 1, dtype=torch.bfloat16)
    params = unet_params(model, 1)
    ops = UK.PlainOps()
    x = torch.rand(2, 45, 80, 16).to(torch.bfloat16)
    ss = torch.stack([torch.rand(2, 16) + 0.5, torch.randn(2, 16)], -1)
    y, part = ops.conv3x3(x, ss, UK.POOL, None, None, params["e4.convs.0.weight"], params["e4.convs.0.bias"])
    assert y.shape == (2, 22, 40, 32) and part.shape == (2, 1, UK.GROUPS, 3)
    x4 = torch.rand(2, 22, 40, 32).to(torch.bfloat16)
    ss4 = torch.stack([torch.rand(2, 32) + 0.5, torch.randn(2, 32)], -1)
    up = ops.conv_t(x4, ss4, params["up3.weight"], params["up3.bias"], UK._output_padding(model, "up3"))
    assert up.shape == (2, 45, 80, 16)
    assert torch.equal(up[:, 44], params["up3.bias"].to(torch.bfloat16).expand(2, 80, 16))


def test_plain_finalize_merges_tiles():
    """Partials of a sample split into tiles merge (Chan's formula, in tile
    order) to the statistics of the whole: the scale and shift of
    GroupNorm's float32 normalisation."""
    torch.manual_seed(0)
    y = torch.randn(2, 12, 16, 16) * 3 + 1  # [B, H, W, C]
    gamma, beta = torch.rand(16) + 0.5, torch.randn(16)
    tiles = []
    for t in range(3):  # three tiles of 4 rows
        v = y[:, 4 * t:4 * t + 4].reshape(2, -1, UK.GROUPS, 2)
        mean = v.mean((1, 3))
        tiles.append(torch.stack([torch.full_like(mean, v.shape[1] * 2), mean,
                                  ((v - mean[:, None, :, None]) ** 2).sum((1, 3))], -1))
    ss = UK.PlainOps.finalize(torch.stack(tiles, 1), gamma, beta)
    want = torch.nn.functional.group_norm(y.permute(0, 3, 1, 2), UK.GROUPS, gamma, beta, 1e-6)
    got = y * ss[:, None, None, :, 0] + ss[:, None, None, :, 1]
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["autoencoder", "unet_f32", "unet_bf16_cpu"])
def test_apply_dispatch_keeps_module_forward(case):
    """The AutoEncoder, a float32 UNet and CPU tensors take the module's
    forward, bitwise, and launch no kernel."""
    if case == "autoencoder":
        model = AutoEncoder(2, 8, 16, 1, 8, out_channels=1, dtype=torch.bfloat16)
        params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    else:
        model = UNet(2, 1, dtype=torch.float32 if case == "unet_f32" else torch.bfloat16)
        params = unet_params(model)
    obs = frames(1, *FULL) if case == "autoencoder" else frames(2, *SMALL)
    before = UK.unet_kernel.launches
    got = make_gaze_predictor_apply(model)(params, obs)
    assert UK.unet_kernel.launches == before
    assert torch.equal(got, module_forward(model, params, obs))


# --- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the UNet kernels have no CPU mode")
    return torch.device("cuda")


def card_forward(b: int, seed: int = 0):
    """(model, params and obs on the card, the kernels' output, launches)."""
    model = UNet(2, 1, dtype=torch.bfloat16).cuda()
    params = {k: v.cuda() for k, v in unet_params(model, seed).items()}
    obs = frames(b, *FULL, seed).cuda()
    before = UK.unet_kernel.launches
    got = make_gaze_predictor_apply(model)(params, obs)
    torch.cuda.synchronize()
    return model, params, obs, got, UK.unet_kernel.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 64])
def test_kernels_match_plain(cuda, b):
    """The kernels against the plain version on the CPU, on the same
    weights and frames; one forward launches LAUNCHES_PER_FORWARD kernels."""
    model, params, obs, got, launches = card_forward(b, b)
    assert launches == UK.LAUNCHES_PER_FORWARD
    assert got.shape == (b, *FULL, 1) and got.dtype == torch.bfloat16 and got.is_cuda
    want = UK.unet_forward(model.cpu(), {k: v.cpu() for k, v in params.items()}, obs.cpu())
    assert rel(got.cpu(), want) <= BAR


@pytest.mark.gpu
def test_kernels_against_float32_unet(cuda):
    """The kernels' heat against the float32 UNet's, no further than the
    module's bf16 forward (on the CPU) is."""
    model, params, obs, got, _ = card_forward(8, 5)
    params, obs = {k: v.cpu() for k, v in params.items()}, obs.cpu()
    want = module_forward(UNet(2, 1), params, obs)
    bf16 = module_forward(model.cpu(), params, obs)
    assert rel(got.cpu(), want) <= F32_RATIO * rel(bf16, want)


@pytest.mark.gpu
def test_kernels_are_bitwise_repeatable(cuda):
    """No atomics: two identical calls give the same bits."""
    model, params, obs, got, _ = card_forward(16, 7)
    again = make_gaze_predictor_apply(model)(params, obs)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
