"""Port parity: the gaze predictor's models (models/encoder.py Decoder and
AutoEncoder, models/unet.py UNet) against the JAX package's flax modules on
the same numpy input, through convert.gaze_params_from_flax.

Bars: float32 outputs within rtol 1e-4 / atol 1e-5; every transposed conv's
output shape is the JAX package's (20x38 -> 22x40 -> 45x80 -> 90x160 ->
180x320; the UNet's 11x20 -> 22x40 -> 45x80 -> 90x160 -> 180x320); a bf16
forward is finite. Widths are tests/test_gaze_keep_best.py's (embedding 4,
hiddens 8, one residual layer of 4), frames 180x320.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gabril_carla_tpu.models import AutoEncoder as JAutoEncoder
from gabril_carla_tpu.models import UNet as JUNet
from gabril_carla_tpu.models.encoder import Decoder as JDecoder
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.models.encoder import AutoEncoder, Decoder, conv_t
from gabril_carla_tpu_torch.models.unet import UNet
from gabril_carla_tpu_torch.utils.config import default_gaze_config
from test_torch_common import nchw

WIDTHS = dict(embedding_dim=4, num_hiddens=8, num_residual_layers=1, num_residual_hiddens=4)
S = 2


def cfg(arch):
    c = default_gaze_config()
    c["model"].update(arch=arch, **WIDTHS)
    return c


def frames(b=2, seed=0):
    return np.random.default_rng(seed).random((b, 180, 320, S), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def jax_model(arch):
    """(flax params as numpy, output NHWC as numpy) on frames()."""
    model = JUNet(output_channels=1) if arch == "unet" else JAutoEncoder(out_channels=1, **WIDTHS)
    x = jnp.asarray(frames())
    params = model.init(jax.random.PRNGKey(0), x[:1])["params"]
    # random GroupNorm affines, so the conversion of scale and bias is seen
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(len(str(p))), a.shape)
        if p[-1].key in ("scale", "bias") and "GroupNorm" in str(p) else a, params)
    out = jax.jit(lambda p, x: model.apply({"params": p}, x))(params, x)
    return jax.tree.map(np.asarray, params), np.asarray(out)


def port_model(arch, dtype=torch.float32):
    if arch == "unet":
        return UNet(S, 1, dtype)
    return AutoEncoder(S, out_channels=1, dtype=dtype, **WIDTHS)


@pytest.mark.parametrize("arch", ["autoencoder", "unet"])
def test_forward_matches_flax(arch):
    params, want = jax_model(arch)
    model = port_model(arch)
    model.load_state_dict(convert.gaze_params_from_flax(params, cfg(arch)))
    with torch.no_grad():
        got = model(nchw(frames()))
    assert got.shape == (2, 1, 180, 320)
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), rtol=1e-4, atol=1e-5)


def test_decoder_matches_flax():
    z = np.random.default_rng(1).standard_normal((2, 20, 38, 4)).astype(np.float32)
    dec = JDecoder(out_channels=1, num_hiddens=8, num_residual_layers=1, num_residual_hiddens=4)
    params = dec.init(jax.random.PRNGKey(3), jnp.asarray(z))["params"]
    want = np.asarray(dec.apply({"params": params}, jnp.asarray(z)))
    named = convert.gaze_params_from_flax(
        {"encoder": jax.tree.map(np.asarray, jax_model("autoencoder")[0]["encoder"]),
         "decoder": jax.tree.map(np.asarray, params)}, cfg("autoencoder"))
    port = Decoder(4, 1, 8, 1, 4)
    port.load_state_dict({k[len("decoder."):]: v for k, v in named.items() if k.startswith("decoder.")})
    with torch.no_grad():
        got = port(nchw(z))
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), rtol=1e-4, atol=1e-5)


# (port layer, input [H, W], the JAX package's output [H, W])
SHAPES = [("decoder.up1", (20, 38), (22, 40)), ("decoder.up2", (22, 40), (45, 80)),
          ("decoder.up3", (45, 80), (90, 160)), ("decoder.up4", (90, 160), (180, 320)),
          ("up4", (11, 20), (22, 40)), ("up3", (22, 40), (45, 80)),
          ("up2", (45, 80), (90, 160)), ("up1", (90, 160), (180, 320))]


@pytest.mark.parametrize("name,hw_in,hw_out", SHAPES, ids=[s[0] for s in SHAPES])
def test_transposed_conv_shapes(name, hw_in, hw_out):
    """Each transposed conv maps its input size to the JAX package's output
    size, and on a random input equals the flax layer with its converted
    kernel (the flip and the pad mapping)."""
    from flax import linen as fnn

    model = port_model("unet" if not name.startswith("decoder") else "autoencoder")
    layer = model.get_submodule(name)
    x = np.random.default_rng(2).standard_normal((1, *hw_in, layer.in_channels)).astype(np.float32)
    k = layer.kernel_size[0]
    pads = {"decoder.up1": "VALID", "decoder.up2": ((2, 3), (2, 2)), "up3": ((1, 2), (1, 1))}.get(
        name, ((2, 2), (2, 2)) if name.startswith("decoder") else "SAME")
    flax_layer = fnn.ConvTranspose(layer.out_channels, (k, k), strides=layer.stride, padding=pads)
    fp = flax_layer.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    want = np.asarray(flax_layer.apply({"params": fp}, jnp.asarray(x)))
    assert want.shape[1:3] == hw_out
    layer.load_state_dict({n: torch.tensor(v) for n, v in
                           convert._conv_t(jax.tree.map(np.asarray, fp)).items()})
    with torch.no_grad():
        got = conv_t(nchw(x), layer, torch.float32)
    assert tuple(got.shape[2:]) == hw_out
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["autoencoder", "unet"])
def test_bf16_forward_is_finite(arch):
    params, _ = jax_model(arch)
    model = port_model(arch, torch.bfloat16)
    model.load_state_dict(convert.gaze_params_from_flax(params, cfg(arch)))
    with torch.no_grad():
        out = model(nchw(frames()))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 1, 180, 320)
    assert bool(torch.isfinite(out).all())


def test_group_norm_follows_flax():
    """GroupNorm: eps 1e-6 and min(8, C) groups, normalized in float32."""
    block = UNet(S, 1, torch.bfloat16).e1
    assert all(n.eps == 1e-6 and n.num_groups == 8 for n in block.norms)
    assert block(torch.rand(1, S, 8, 8)).dtype == torch.float32
    assert F.max_pool2d(torch.zeros(1, 1, 45, 80), 2).shape[2:] == (22, 40)
