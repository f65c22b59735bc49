"""Card tests of the port's render kernel (marker ``gpu``).

They need a CUDA card and skip without one; the CPU parity tests in
tests/test_torch_render.py hold the plain version to the JAX package. This
file imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_card.py -q

Bar: tests/test_raster.py's, fewer than 1% of pixels off by more than 1e-3
and a median difference below 1e-5, per frame.
"""

import numpy as np
import pytest
import torch

from gabril_carla_tpu_torch.data.tasks import seen_routes
from gabril_carla_tpu_torch.env.env import DrivingEnv
from gabril_carla_tpu_torch.env.world import build_world_spec, load_benchmark_specs, stack_specs, to_torch
from gabril_carla_tpu_torch.ops import raster as R
from gabril_carla_tpu_torch.ops import render_kernel as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the render kernel has no CPU mode")
    return torch.device("cuda")


def _operands(spec, state):
    cam, fwd, right = R._camera_basis(state.ego.pos, state.ego.yaw)
    boxes = torch.cat([R._collect_actor_boxes(state, cam, fwd, right),
                       R._signal_boxes(spec, state, cam, fwd, right)], 1)
    return R._pallas_inputs(spec, state, cam, fwd, right, boxes, R.weather_now(spec, state))


def _assert_frames_match(a, b):
    d = (a - b).abs().flatten(1)
    assert ((d > 1e-3).float().mean(1) < 0.01).all()
    assert (d.median(1).values < 1e-5).all()


def test_kernel_matches_plain_on_real_routes(cuda):
    spec = to_torch(load_benchmark_specs(seen_routes()[:3]), cuda)
    state = DrivingEnv().reset(spec)
    ops = _operands(spec, state)
    before = K.render_kernel.launches
    out = K.render_from_operands(*ops)
    torch.cuda.synchronize()
    assert K.render_kernel.launches == before + 1
    assert out.shape == (3, 180, 320) and out.dtype == torch.float32
    _assert_frames_match(out, K.render_from_operands_plain(*ops))


def test_kernel_matches_plain_with_crossing_flow(cuda):
    wps = np.stack([np.arange(0.0, 160, 2.0), np.zeros(80)], 1).astype(np.float32)
    spec = to_torch(stack_specs([build_world_spec({
        "id": 2, "town": "T", "waypoints": wps, "weather": [0, 0, 0, 90],
        "scenarios": [{"type": "CrossingBicycleFlow", "trigger": (40.0, 0.0, 0.0),
                       "start_actor_flow": (60.0, -40.0), "end_actor_flow": (60.0, 40.0),
                       "flow_speed": 8.0, "source_dist_interval": (12.0, 25.0)}]})]), cuda)
    st = DrivingEnv().reset(spec)
    st = st.replace(ego=st.ego.replace(pos=torch.tensor([[30.0, 0.0]], device=cuda),
                                       route_idx=torch.full_like(st.ego.route_idx, 30)))
    ops = _operands(spec, st)
    _assert_frames_match(K.render_from_operands(*ops), K.render_from_operands_plain(*ops))


def test_render_frame_launches_once_per_call(cuda):
    spec = to_torch(load_benchmark_specs(seen_routes()[:1]), cuda)
    state = DrivingEnv().reset(spec)
    before = K.render_kernel.launches
    R.render_frame(spec, state)
    R.render_frame(spec, state)
    assert K.render_kernel.launches == before + 2


def test_wrapper_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        K.render_from_operands(torch.zeros(1, 18, device=cuda), torch.zeros(1, 160, 8),
                               torch.zeros(1, 32, 8, device=cuda))


def test_wrapper_rejects_misaligned_operands(cuda):
    rows = torch.zeros(160 * 8 + 1, device=cuda)[1:].view(1, 160, 8)  # contiguous, 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        K.render_from_operands(torch.zeros(1, 18, device=cuda), rows,
                               torch.zeros(1, 32, 8, device=cuda))
