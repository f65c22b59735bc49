"""Port parity: the eval policy's input branches (train/bc.py:
make_bc_policy_fn) for every gaze x dropout method with gaze heat, at
24x48, against gabril_carla_tpu's make_bc_policy_fn with converted flax
parameters: float32 within atol 1e-4, as tests/test_torch_policy.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.train import bc as PB
from test_torch_common import bc_batch, bc_cfgs


@pytest.mark.parametrize("dropout", PB.DROPOUT_METHODS)
@pytest.mark.parametrize("gaze", PB.GAZE_METHODS)
def test_policy_branches_match(gaze, dropout):
    """Every input branch of the eval policy (Mask, ViSaRL, AGIL's second
    encoder, GMD and IGMD test mode) with heat, and with heat None (zeros)."""
    jcfg, pcfg = bc_cfgs(gaze, dropout)
    models = JB.build_bc_models(jcfg)
    params = JB.init_bc_params(models, jcfg, jax.random.PRNGKey(3))
    state = convert.params_from_flax(jax.tree.map(np.asarray, params), pcfg)
    batch = bc_batch()
    xx, heat, _ = models.heatmapper.prepare_for_bc(jnp.asarray(batch["obs_seq"]),
                                                   jnp.asarray(batch["gaze_seq"]), 2, grayscale=True)
    policy = PB.make_bc_policy_fn(PB.build_bc_models(pcfg, device="cpu"), pcfg)
    for h in (heat, None):
        want = np.asarray(JB.make_bc_policy_fn(models, jcfg)(params, xx, h))
        got = policy(state, torch.from_numpy(np.asarray(xx)), None if h is None else torch.from_numpy(np.asarray(h)))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
