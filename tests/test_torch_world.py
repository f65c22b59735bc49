"""Port parity: the world compile (gabril_carla_tpu_torch/env/world.py).

Every WorldSpec array the port builds is bitwise equal to the JAX package's,
for the 20 real benchmark routes and for the fixture routes of
tests/test_scenarios_ext.py. Tolerance: none (the compile is numpy in both).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gabril_carla_tpu.env.world as JW
import gabril_carla_tpu_torch.env.world as PW
from gabril_carla_tpu.data.tasks import seen_routes, unseen_routes
from gabril_carla_tpu_torch.data.tasks import seen_routes as p_seen, unseen_routes as p_unseen


def straight(n=300):
    return np.stack([np.arange(0.0, n, 2.0), np.zeros(n // 2)], 1).astype(np.float32)


def l_shaped():
    a = np.stack([np.arange(0.0, 100, 2.0), np.zeros(50)], 1)
    th = np.linspace(0, np.pi / 2, 16)[1:]
    r = 12.0
    arc = np.stack([100.0 + r * np.sin(th), -(r - r * np.cos(th))], 1)
    b = arc[-1] + np.stack([np.zeros(40), -np.arange(2.0, 82, 2.0)], 1)
    return np.concatenate([a, arc, b]).astype(np.float32)


# the scenario instances tests/test_scenarios_ext.py builds
FIXTURES = [
    (straight(), {"type": "Accident", "trigger": (40.0, 0.0, 0.0), "distance": 30.0}),
    (straight(), {"type": "ConstructionObstacleTwoWays", "trigger": (40.0, 0.0, 0.0),
                  "distance": 30.0, "frequency": (40.0, 80.0)}),
    (straight(), {"type": "ParkedObstacle", "trigger": (40.0, 0.0, 0.0), "distance": 30.0}),
    (l_shaped(), {"type": "SignalizedJunctionLeftTurn", "trigger": (80.0, 0.0, 0.0),
                  "flow_speed": 9.0, "source_dist_interval": (15.0, 25.0)}),
    (l_shaped(), {"type": "NonSignalizedJunctionRightTurn", "trigger": (80.0, 0.0, 0.0),
                  "flow_speed": 9.0, "source_dist_interval": (15.0, 25.0)}),
    (l_shaped(), {"type": "VanillaSignalizedTurnEncounterRedLight", "trigger": (90.0, 0.0, 0.0)}),
    (straight(400), {"type": "YieldToEmergencyVehicle", "trigger": (6.0, 0.0, 0.0),
                     "distance": 25.0}),
    (straight(400), {"type": "HardBreakRoute", "trigger": (50.0, 0.0, 0.0)}),
    (l_shaped(), {"type": "OppositeVehicleTakingPriority", "trigger": (85.0, 0.0, 0.0),
                  "direction": "right"}),
    (straight(400), {"type": "ControlLoss", "trigger": (60.0, 0.0, 0.0)}),
    (straight(400), {"type": "None", "trigger": (60.0, 0.0, 0.0)}),
    (straight(300), {"type": "ParkingExit", "trigger": (2.0, 0.0, 0.0),
                     "front_vehicle_distance": 9.0, "behind_vehicle_distance": 9.0}),
    (straight(400), {"type": "InvadingTurn", "trigger": (40.0, 0.0, 0.0), "distance": 60.0,
                     "offset": 0.3}),
]


def assert_specs_equal(a, b):
    for f in dataclasses.fields(JW.WorldSpec):
        x, y = np.asarray(getattr(a, f.name)), getattr(b, f.name)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(y, x, err_msg=f.name)


def test_task_splits_match():
    assert p_seen() == seen_routes() and p_unseen() == unseen_routes()


def test_real_routes_bitwise():
    ids = seen_routes() + unseen_routes()
    ref = JW.load_benchmark_specs(None, ids)
    port = PW.load_benchmark_specs(ids)
    assert_specs_equal(ref, port)
    # and through to_torch onto a device (dtypes kept)
    assert_specs_equal(ref, PW.to_torch(port, "cpu"))


@pytest.mark.parametrize("i", range(len(FIXTURES)))
def test_fixture_routes_bitwise(i):
    wps, scen = FIXTURES[i]
    route = {"id": 7, "town": "T", "waypoints": wps, "scenarios": [scen],
             "weather": [0, 0, 0, 90]}
    assert_specs_equal(JW.build_world_spec(route), PW.build_world_spec(route))


def test_stack_specs_matches():
    routes = [{"id": 7, "town": "T", "waypoints": w, "scenarios": [s], "weather": [0, 0, 0, 90]}
              for w, s in FIXTURES[:4]]
    ref = JW.stack_specs([JW.build_world_spec(r) for r in routes])
    assert_specs_equal(jax.tree.map(np.asarray, ref),
                       PW.stack_specs([PW.build_world_spec(r) for r in routes]))
