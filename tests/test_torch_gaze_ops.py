"""Port parity: the gaze ops (ops/image.py, ops/heatmap.py, ops/gaze.py) and
the vector quantizer (models/vq.py), against the JAX package on the same
numpy inputs.

Bars: the bicubic resize matrix bitwise (both are the same numpy code);
window indices exactly; float32 resizes, stacks and heatmaps within 1e-6
absolute (values in [0, 1]; only the matmul summation order differs); the
saliency mask and its gradient within 1e-5 of their scale; GMD with JAX's
replayed uniforms exactly in its mask and within 1e-6 in value; VQ indices
exactly and the quantized latent within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabril_carla_tpu.models.vq import VectorQuantizer as FlaxVQ
from gabril_carla_tpu.ops import gaze as JG
from gabril_carla_tpu.ops import heatmap as JH
from gabril_carla_tpu.ops import image as JI
from gabril_carla_tpu_torch.models.vq import VectorQuantizer
from gabril_carla_tpu_torch.ops import gaze as PG
from gabril_carla_tpu_torch.ops import heatmap as PH
from gabril_carla_tpu_torch.ops import image as PI
from gabril_carla_tpu_torch.ops.threefry_kernel import uniform
from test_torch_common import nchw

P = 5


def coords(rng, shape, p=P):
    c = rng.random((*shape, p, 2)).astype(np.float32)
    c[rng.random((*shape, p)) < 0.3] = -1.0
    return c.reshape(*shape, p * 2)


@pytest.mark.parametrize("sizes", [(20, 180), (38, 320), (180, 20), (320, 38), (24, 24), (7, 13)])
def test_resize_matrix_bitwise(sizes):
    a, b = sizes
    np.testing.assert_array_equal(PI.bicubic_resize_matrix(a, b), JI.bicubic_resize_matrix(a, b))


@pytest.mark.parametrize("in_hw,out_hw", [((20, 38), (180, 320)), ((180, 320), (20, 38)),
                                          ((90, 160), (45, 80))])
def test_resize_bicubic_matches(in_hw, out_hw):
    x = np.random.default_rng(0).random((3, *in_hw), dtype=np.float32)
    want = np.asarray(JI.resize_bicubic(jnp.asarray(x), *out_hw))
    got = PI.resize_bicubic(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("grayscale,c", [(True, 3), (True, 1), (False, 3)])
def test_format_obs_stack_matches(grayscale, c):
    imgs = np.random.default_rng(1).integers(0, 256, (2, 3, 12, 20, c), dtype=np.uint8)
    want = np.asarray(JI.format_obs_stack(jnp.asarray(imgs), grayscale))
    got = PI.format_obs_stack(torch.from_numpy(imgs), grayscale)
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("center,s,n", [(0, 2, 4), (3, 2, 4), (5, 4, 6), (2, 5, 3)])
def test_window_indices_equal(center, s, n):
    np.testing.assert_array_equal(PI.stack_window_indices(center, s, n), JI.stack_window_indices(center, s, n))


def mappers(h=36, w=64, **kw):
    args = dict(img_height=h, img_width=w, gaze_sigma=5.0, maxpoints=P, **kw)
    return JH.GazeHeatmapper(**args), PH.GazeHeatmapper(**args)


def test_heatmaps_match():
    g = coords(np.random.default_rng(2), (4, 3))
    jm, pm = mappers()
    want = np.asarray(jm.heatmaps(jnp.asarray(g)))
    np.testing.assert_allclose(pm.heatmaps(torch.from_numpy(g)).numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["alpha_decay", "multiscale"])
def test_stack_heatmaps_match(mode):
    g = coords(np.random.default_rng(3), (2, 4))
    jm, pm = mappers(temporal_mode=mode, temporal_sigmas=(3.0, 5.0, 8.0), temporal_coeffs=(1.0, 0.5))
    want = np.asarray(jm.build_stack_heatmaps(jnp.asarray(g), 3, 3))
    got = pm.build_stack_heatmaps(torch.from_numpy(g), 3, 3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("aggregate", [True, False])
def test_prepare_for_bc_matches(aggregate):
    rng = np.random.default_rng(4)
    obs = rng.integers(0, 256, (3, 2, 36, 64, 3), dtype=np.uint8)
    g = coords(rng, (3, 2))
    jm, pm = mappers()
    jx, jh, jc = jm.prepare_for_bc(jnp.asarray(obs), jnp.asarray(g), 2, grayscale=True,
                                   aggregate_stack=aggregate)
    px, ph, pc = pm.prepare_for_bc(torch.from_numpy(obs), torch.from_numpy(g), 2, grayscale=True,
                                   aggregate_stack=aggregate)
    assert pc == jc
    np.testing.assert_allclose(px.numpy(), nchw(jx).numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ph.numpy(), nchw(jh).numpy(), atol=1e-6, rtol=0)


def test_prepare_for_gaze_predictor_matches():
    rng = np.random.default_rng(5)
    obs = rng.integers(0, 256, (2, 3, 36, 64, 1), dtype=np.uint8)
    g = coords(rng, (2, 3))
    jm, pm = mappers()
    jx, jt, _ = jm.prepare_for_gaze_predictor(jnp.asarray(obs), jnp.asarray(g), 2)
    px, pt, _ = pm.prepare_for_gaze_predictor(torch.from_numpy(obs), torch.from_numpy(g), 2)
    np.testing.assert_allclose(px.numpy(), nchw(jx).numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pt.numpy(), nchw(jt).numpy(), atol=1e-6, rtol=0)


def test_gaze_mask_from_latent_and_grad_match():
    z = np.random.default_rng(6).standard_normal((3, 5, 6, 8)).astype(np.float32)  # NHWC
    w = np.random.default_rng(7).random((3, 24, 48)).astype(np.float32)

    def jf(zz):
        return jnp.sum(JG.gaze_mask_from_latent(zz, 2.0, (24, 48)) * w)

    want_v = np.asarray(JG.gaze_mask_from_latent(jnp.asarray(z), 2.0, (24, 48)))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(z)))
    zt = nchw(z).requires_grad_()
    got = PG.gaze_mask_from_latent(zt, 2.0, (24, 48))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want_v, atol=1e-5 * np.abs(want_v).max(), rtol=0)
    want_g = np.transpose(want_g, (0, 3, 1, 2))
    np.testing.assert_allclose(zt.grad.numpy(), want_g, atol=1e-5 * np.abs(want_g).max(), rtol=0)


def gmd_inputs(seed=8):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((3, 4, 6, 5)).astype(np.float32)  # NHWC latent
    g = rng.random((3, 24, 48, 2)).astype(np.float32)  # NHWC heat stack
    return z, g


def test_gmd_test_mode_matches():
    z, g = gmd_inputs()
    want = np.asarray(JG.gmd_dropout(jnp.asarray(z), jnp.asarray(g), test_mode=True))
    got = PG.gmd_dropout(nchw(z), nchw(g), test_mode=True)
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), atol=1e-6, rtol=0)


def test_gmd_train_mode_replays_jax_uniforms():
    z, g = gmd_inputs(9)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JG.gmd_dropout(jnp.asarray(z), jnp.asarray(g), key=key))
    a = nchw(jax.random.uniform(key, (3, 4, 6, 1), dtype=jnp.float32))
    # the port draws the same uniforms from the same key (ops/threefry_kernel.py)
    assert torch.equal(uniform(np.asarray(key), (3, 1, 4, 6), "cpu"), a)
    got = PG.gmd_dropout(nchw(z), nchw(g), uniforms=a)
    want = nchw(want)
    np.testing.assert_array_equal(got.numpy() == 0, want.numpy() == 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        PG.gmd_dropout(nchw(z), nchw(g))  # train mode without its uniforms


def test_vq_forward_matches():
    rng = np.random.default_rng(10)
    z = rng.standard_normal((2, 4, 6, 8)).astype(np.float32) * 0.05
    fq = FlaxVQ(8, 16, 0.25)
    p = fq.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"]
    want = fq.apply({"params": p}, jnp.asarray(z))
    vq = VectorQuantizer(8, 16, 0.25)
    with torch.no_grad():
        vq.codebook.copy_(torch.from_numpy(np.array(p["codebook"])))
        got = vq(nchw(z))
    np.testing.assert_array_equal(got.encoding_indices.numpy(), np.asarray(want.encoding_indices))
    np.testing.assert_allclose(got.quantized.numpy(), nchw(want.quantized).numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), rtol=1e-5)
    np.testing.assert_allclose(float(got.perplexity), float(want.perplexity), rtol=1e-5)
