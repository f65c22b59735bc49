"""Port parity for the gaze-heat eval path, continued from
tests/test_torch_rollout_heat.py (its helpers and bars): Mask with a frozen
AutoEncoder predictor, its flax parameters converted, and the confounded
two-pass with gaze None, closed loop against the JAX package's
make_rollout_fn on replayed draws.
"""

import pytest

from test_torch_rollout_heat import check_against_jax


@pytest.mark.parametrize("case", ["mask_predictor", "confounded"])
def test_heat_rollout_matches_jax(case):
    check_against_jax(case)
