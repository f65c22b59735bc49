"""Port parity: the BC loss and its gradients (train/bc.py) against
jax.value_and_grad(gabril_carla_tpu.train.bc.bc_loss_fn), at 24x48 as
tests/test_train_bc.py runs, float32, on the same numpy batch, converted
flax parameters and JAX's replayed dropout draws.

Bars (test_torch_common.check_against_jax): loss and metrics rtol 1e-5;
every gradient leaf within 1e-4 of the JAX leaf's largest magnitude (both
run float32 on the CPU; only summation orders differ).

Oreo with a regularizer (Teacher, Reg, Contrastive, GRIL) is held to JAX at
oreo_num_mask 1: at 2 the JAX package fails on a shape mismatch, and the
port tiles the regularizer's targets
(test_torch_train_cases.py: test_oreo_tiles_regularizer_targets).
The partial-gaze hash, the Contrastive gate, GRIL's padding, the draws and
a full-width bf16 step are in test_torch_train_cases.py; this file runs
dropout None and GMD, test_torch_train_dropout.py IGMD and Oreo.
"""

import pytest

from gabril_carla_tpu_torch.train import bc as PB
from test_torch_common import bc_cfgs, check_against_jax, check_method


@pytest.mark.parametrize("dropout", ["None", "GMD"])
@pytest.mark.parametrize("gaze", PB.GAZE_METHODS)
def test_loss_and_grads_match_jax(gaze, dropout):
    check_method(gaze, dropout)


@pytest.mark.parametrize("dist", ["TV", "KL", "JS"])
def test_prob_dist_types_match(dist):
    check_against_jax(*bc_cfgs("Reg", **{"gaze.prob_dist_type": dist}))


@pytest.mark.parametrize("over", [
    {"gaze.temporal_mode": "multiscale", "gaze.temporal_sigmas": [3.0, 6.0],
     "gaze.temporal_coeffs": [1.0, 0.5]},
    {"gaze.temporal_flag": False}], ids=["multiscale", "per_step"])
def test_temporal_modes_match(over):
    check_against_jax(*bc_cfgs("Teacher", "IGMD", **over))


def test_eval_mode_loss_matches():
    """train=False: GMD and IGMD in their expected-value form."""
    for dropout in ("GMD", "IGMD"):
        check_against_jax(*bc_cfgs("Reg", dropout), train=False)
