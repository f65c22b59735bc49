"""Port parity, the BC loss's special cases (train/bc.py): the
partial-gaze content hash and ratio, the Contrastive blank-gaze gate, GRIL's
padding mask, Oreo's m-major tiling, the draws' checks, and one bf16 step
of bench_train.py's method at full width. Bars as test_torch_train.py's
unless a test states its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.ops.threefry_kernel import bernoulli
from gabril_carla_tpu_torch.utils.prng import prng_key
from test_torch_common import (REG_METHODS, bc_batch, bc_cfgs, check_against_jax, jax_loss,
                               port_loss, torch_batch)


def jax_gaze_hash(per_key):
    """bc.py:252-254, verbatim."""
    kbits = jax.lax.bitcast_convert_type(per_key, jnp.int32)
    h = kbits * jnp.int32(-1640531527)
    return (h & jnp.int32(32767)).astype(jnp.float32) / 32768.0


def test_gaze_hash_bitwise():
    rng = np.random.default_rng(3)
    keys = np.concatenate([rng.uniform(0, 5e4, 500), rng.uniform(-1e6, 1e6, 500),
                           [0.0, -0.0, 1.0, 3e38]]).astype(np.float32)
    want = np.asarray(jax_gaze_hash(jnp.asarray(keys)))
    got = PB.gaze_hash(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_partial_gaze_ratio_matches(ratio):
    """The content keys (frame sums) are summed in another order by each
    framework, so the port is given JAX's keys; the hash is bitwise above."""
    jcfg, pcfg = bc_cfgs("Reg", **{"gaze.ratio": ratio, "data.batch_size": 8})
    batch = bc_batch(8)
    hm = JB.build_bc_models(jcfg).heatmapper
    xx, _, _ = hm.prepare_for_bc(jnp.asarray(batch["obs_seq"]), jnp.asarray(batch["gaze_seq"]),
                                 frame_stack=2, grayscale=True)
    per_key = jnp.sum(xx.astype(jnp.float32), axis=(1, 2, 3))
    chosen = int(np.sum(np.asarray(jax_gaze_hash(per_key)) < ratio))
    metrics = check_against_jax(jcfg, pcfg, batch, per_key=torch.from_numpy(np.asarray(per_key)))
    assert chosen == {0.0: 0, 1.0: 8}.get(ratio, chosen) and (ratio != 0.5 or 0 < chosen < 8)
    assert (metrics["loss_reg"] == 0.0) == (ratio == 0.0)


def test_contrastive_blank_gaze_gated_out():
    """tests/test_train_bc.py's gate contract, on the port and against JAX:
    blank gaze gives loss_reg 0; half the samples blank gives the valid
    half's mean."""
    jcfg, pcfg = bc_cfgs("Contrastive")
    batch = bc_batch()
    blank = dict(batch, gaze_seq=np.full_like(batch["gaze_seq"], -1.0))
    assert check_against_jax(jcfg, pcfg, blank)["loss_reg"] == 0.0
    tile = {k: np.repeat(v[:1], 4, axis=0) for k, v in batch.items()}
    gz = np.full_like(tile["gaze_seq"], 0.5)
    m_all = check_against_jax(jcfg, pcfg, dict(tile, gaze_seq=gz))
    gz_half = gz.copy()
    gz_half[2:] = -1.0
    m_half = check_against_jax(jcfg, pcfg, dict(tile, gaze_seq=gz_half))
    assert m_all["loss_reg"] > 0.0
    np.testing.assert_allclose(m_half["loss_reg"], m_all["loss_reg"], rtol=1e-5)


def test_gril_masks_invalid_padding():
    """-1 padded gaze slots stay out of GRIL's coordinate MSE; an all-padded
    batch gives loss_reg 0 (tests/test_train_bc.py's contract), against JAX."""
    jcfg, pcfg = bc_cfgs("GRIL")
    batch = bc_batch()
    gz = np.full_like(batch["gaze_seq"], 0.5)
    gz_pad = gz.copy()
    gz_pad[..., 2:] = -1.0
    assert np.isfinite(check_against_jax(jcfg, pcfg, dict(batch, gaze_seq=gz_pad))["loss_reg"])
    assert check_against_jax(jcfg, pcfg, dict(batch, gaze_seq=np.full_like(gz, -1.0)))["loss_reg"] == 0.0


@pytest.mark.parametrize("gaze", REG_METHODS)
def test_oreo_tiles_regularizer_targets(gaze):
    """Oreo with m masks is m copies of the batch: its loss is the mean of
    the m single-mask losses, each with its block of the code mask."""
    _, pcfg2 = bc_cfgs(gaze, "Oreo")
    _, pcfg1 = bc_cfgs(gaze, "Oreo", **{"dropout.oreo_num_mask": 1})
    models = PB.build_bc_models(pcfg2, device="cpu")
    params = PB.init_bc_params(models, pcfg2, prng_key(0))
    batch = torch_batch(bc_batch())
    mask = bernoulli(prng_key(1), 0.5, (8, 16), "cpu")
    loss2, m2 = PB.bc_loss_fn(params, models, pcfg2, batch, {"oreo": mask})
    halves = [PB.bc_loss_fn(params, models, pcfg1, batch, {"oreo": mask[i:i + 4]})[1] for i in (0, 4)]
    for k in m2:
        np.testing.assert_allclose(float(m2[k]), 0.5 * float(halves[0][k] + halves[1][k]), rtol=1e-5, err_msg=k)
    assert float(m2["loss_reg"]) > 0


def test_draws_are_checked():
    _, pcfg = bc_cfgs("Reg", "GMD")
    models = PB.build_bc_models(pcfg, device="cpu")
    params = PB.init_bc_params(models, pcfg, prng_key(0))
    batch = torch_batch(bc_batch())
    with pytest.raises(ValueError, match="key"):
        PB.bc_loss_fn(params, models, pcfg, batch)
    with pytest.raises(ValueError, match="gmd"):
        PB.bc_loss_fn(params, models, pcfg, batch, {"gmd": torch.zeros(4, 1, 2, 2)})
    loss, _ = PB.bc_loss_fn(params, models, pcfg, batch, prng_key(2))
    assert torch.isfinite(loss)


def test_remat_matches():
    """training.remat recomputes the encoder in the backward
    (torch.utils.checkpoint): the same loss and gradients, IGMD's masks
    included, as without it."""
    _, pcfg = bc_cfgs("Reg", "IGMD")
    _, pcfg_remat = bc_cfgs("Reg", "IGMD", **{"training.remat": True})
    models = PB.build_bc_models(pcfg, device="cpu")
    params = PB.init_bc_params(models, pcfg, prng_key(0))
    batch = torch_batch(bc_batch())
    draws = PB.step_draws(prng_key(1), pcfg, 4, "cpu")
    loss, _, grads = PB.loss_and_grads(models, pcfg, params, batch, draws)
    loss_r, _, grads_r = PB.loss_and_grads(models, pcfg_remat, params, batch, draws)
    assert torch.equal(loss, loss_r)
    for k in grads:
        torch.testing.assert_close(grads_r[k], grads[k], rtol=1e-6, atol=1e-7 * float(grads[k].abs().max()))


def test_bf16_reg_step_matches():
    """bench_train.py's method (Reg, beta 50, bf16) at full width, 180x320,
    batch 2. bf16 keeps 8 significant bits and flax and torch round at
    different points (test_torch_policy.py: test_bf16_policy_matches), so
    the bounds are bf16 ones: loss and metrics within 1% of JAX's (measured
    0.18%); each gradient leaf no farther from JAX's float32 gradient than
    1.25x JAX's own bf16 gradient is, plus 1% of the leaf's scale (measured
    at most 1.08x: bf16 gradients sit 1-26% of their scale off float32 in
    both packages)."""
    from gabril_carla_tpu.utils import default_bc_config
    from gabril_carla_tpu_torch.utils.config import default_bc_config as port_default

    jcfg, pcfg = default_bc_config(), port_default()
    j32 = default_bc_config()
    j32["training"]["compute_dtype"] = "float32"
    batch = bc_batch(2, hw=(180, 320), max_points=5)
    params, loss, metrics, grads = jax_loss(jcfg, batch, jit=True)
    _, _, _, grads32 = jax_loss(j32, batch, jit=True)
    p_loss, p_metrics, p_grads = port_loss(pcfg, params, batch, {})
    for k in metrics:
        np.testing.assert_allclose(p_metrics[k], metrics[k], rtol=0.01, err_msg=k)
    assert metrics["loss_reg"] > 0
    want = convert.params_from_flax(jax.tree.map(np.asarray, grads), pcfg)
    ref = convert.params_from_flax(jax.tree.map(np.asarray, grads32), pcfg)
    for k, r in ref.items():
        scale = float(r.abs().max())
        port_err = float((p_grads[k] - r).abs().max()) / scale
        jax_err = float((want[k] - r).abs().max()) / scale
        assert port_err <= 1.25 * jax_err + 0.01, (k, port_err, jax_err)
