"""Port parity: the BC loss and its gradients (train/bc.py) for every gaze
method with the dropout methods IGMD and Oreo, against
jax.value_and_grad(gabril_carla_tpu.train.bc.bc_loss_fn) with JAX's draws
replayed; bars and configuration as tests/test_torch_train.py's, which runs
dropout None and GMD.
"""

import pytest

from gabril_carla_tpu_torch.train import bc as PB
from test_torch_common import check_method


@pytest.mark.parametrize("dropout", ["IGMD", "Oreo"])
@pytest.mark.parametrize("gaze", PB.GAZE_METHODS)
def test_loss_and_grads_match_jax(gaze, dropout):
    check_method(gaze, dropout)
