"""Port parity: the heat-input gaze methods at the anchor's size.

tests/test_torch_policy_branches.py and test_torch_train_cases.py hold
every method at 24x48 with tiny widths; this file runs the three gaze
methods that take heat as input (Mask: the frames times the heat, ViSaRL:
the heat as extra channels, AGIL: a second encoder on the masked frames)
at the size the round-5 anchor trains and evaluates them:
default_bc_config()'s 180x320 grayscale frames, frame stack 2 and full
widths (hiddens 128, z_dim 256), in float32, on the human-gaze heat the
training batch carries (prepare_for_bc: mask_sigma 30 at 180x320). The
eval policy against gabril_carla_tpu's make_bc_policy_fn with converted
flax parameters within atol 1e-4, as the small test; the training loss
and gradients against jax.value_and_grad(bc_loss_fn) at the small tests'
bars (loss and metrics rtol 1e-5, each gradient leaf within 1e-4 of its
largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu.utils import default_bc_config
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.utils.config import default_bc_config as port_default
from test_torch_common import KEY, assert_grads_close, bc_batch, he_params, jax_bc_draws, jax_loss, port_loss

METHODS = ["Mask", "ViSaRL", "AGIL"]


def full_size_cfgs(gaze: str, dtype: str = "float32"):
    """(JAX config, port config): default_bc_config() with ``gaze``, no
    dropout, in ``dtype``."""
    cfgs = []
    for make in (default_bc_config, port_default):
        cfg = make()
        cfg["gaze"]["method"] = gaze
        cfg["dropout"]["method"] = "None"
        cfg["training"]["compute_dtype"] = dtype
        cfgs.append(cfg)
    assert (cfgs[0].data["img_height"], cfgs[0].data["img_width"]) == (180, 320)
    assert cfgs[0].model["num_hiddens"] == 128 and cfgs[0].model["z_dim"] == 256
    return tuple(cfgs)


@pytest.mark.parametrize("gaze", METHODS)
def test_heat_branches_at_full_size(gaze):
    jcfg, pcfg = full_size_cfgs(gaze)
    hw = (jcfg.data["img_height"], jcfg.data["img_width"])
    models = JB.build_bc_models(jcfg)
    params = he_params(models, jcfg, seed=3)
    state = convert.params_from_flax(jax.tree.map(np.asarray, params), pcfg)
    batch = bc_batch(1, seed=7, hw=hw, max_points=jcfg.gaze["max_points"])
    xx, heat, _ = models.heatmapper.prepare_for_bc(jnp.asarray(batch["obs_seq"]),
                                                   jnp.asarray(batch["gaze_seq"]),
                                                   jcfg.data["frame_stack"], grayscale=True)
    assert float(jnp.max(heat)) > 0.5
    want = np.asarray(JB.make_bc_policy_fn(models, jcfg)(params, xx, heat))
    policy = PB.make_bc_policy_fn(PB.build_bc_models(pcfg, device="cpu"), pcfg)
    with torch.inference_mode():
        got = policy(state, torch.from_numpy(np.asarray(xx)), torch.from_numpy(np.asarray(heat)))
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, jcfg.data["action_dim"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("gaze", METHODS)
def test_heat_train_step_at_full_size(gaze):
    jcfg, pcfg = full_size_cfgs(gaze)
    batch = bc_batch(2, seed=7, hw=(180, 320), max_points=jcfg.gaze["max_points"])
    params, loss, metrics, grads = jax_loss(jcfg, batch, jit=True)
    p_loss, p_metrics, p_grads = port_loss(pcfg, params, batch, jax_bc_draws(jcfg, KEY, 2))
    np.testing.assert_allclose(p_loss, loss, rtol=1e-5)
    for k in metrics:
        np.testing.assert_allclose(p_metrics[k], metrics[k], rtol=1e-5, err_msg=k)
    assert_grads_close(p_grads, grads, pcfg, 1e-4)
