"""Port parity: the env step (env/state.py, traffic_lights.py, dynamics.py,
scenarios.py, ambient.py, criteria.py, env.py).

* reset: every leaf of the port's reset equals the JAX package's;
* one step from identical injected states, for every scenario family of
  scenarios._BRANCHES (0-13): the worlds are driven by the JAX expert,
  states are taken at several ticks, and the port steps them with JAX's
  actions and random draws of that tick; JAX's next state is the reference;
* criteria_step on crafted collision states (vehicle, walker, static, a
  deduplicated repeat);
* a 50-tick open-loop rollout of three real routes with JAX's (expert)
  actions and JAX's replayed draws: compute_score equal within 1e-4.
Integer and bool leaves must be equal; float leaves agree within rtol 1e-5
/ atol 1e-5 (relative: the worlds' coordinates reach thousands of metres).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabril_carla_tpu.data.tasks import seen_routes
from gabril_carla_tpu.env import DrivingEnv
from gabril_carla_tpu.env import criteria as JC
from gabril_carla_tpu.env.criteria import compute_score
from gabril_carla_tpu.env.expert import expert_action
from gabril_carla_tpu.env.world import build_world_spec, load_benchmark_specs, stack_specs
from gabril_carla_tpu_torch.env import criteria as PC
from gabril_carla_tpu_torch.env.env import DrivingEnv as PortEnv, decode_action
from test_torch_common import assert_states_close, port_spec, port_state, rollout_draws


def straight(n=300):
    return np.stack([np.arange(0.0, n, 2.0), np.zeros(n // 2)], 1).astype(np.float32)


def l_shaped():
    a = np.stack([np.arange(0.0, 100, 2.0), np.zeros(50)], 1)
    th = np.linspace(0, np.pi / 2, 16)[1:]
    r = 12.0
    arc = np.stack([100.0 + r * np.sin(th), -(r - r * np.cos(th))], 1)
    b = arc[-1] + np.stack([np.zeros(40), -np.arange(2.0, 82, 2.0)], 1)
    return np.concatenate([a, arc, b]).astype(np.float32)


def turn_route(leg1=140.0, leg2=120.0):
    """tests/test_junction_ambient.py: straight +x leg, corner, +y leg."""
    a = np.stack([np.arange(0.0, leg1, 2.0), np.zeros(int(leg1 // 2))], 1)
    b = np.stack([np.full(int(leg2 // 2), leg1 - 2.0), np.arange(2.0, leg2 + 2.0, 2.0)], 1)
    return np.concatenate([a, b]).astype(np.float32)


def _flow(x, speed=8.0, gap=(12.0, 25.0)):
    return {"start_actor_flow": (x, -40.0), "end_actor_flow": (x, 40.0), "flow_speed": speed,
            "source_dist_interval": gap}


# family (scenarios._BRANCHES index) -> route; scenes after tests/test_env.py,
# test_scenarios_ext.py, test_multi_scenario.py, test_ambient.py and
# test_junction_ambient.py
FAMILIES = {
    "0_passive": (straight(200), {"type": "None", "trigger": (30.0, 0.0, 0.0)}),
    "0_junction_ambient": (turn_route(), {"type": "None"}),
    "1_cut_in": (straight(300), {"type": "ParkingCutIn", "trigger": (40.0, 0.0, 0.0)}),
    "2_obstacle_two_ways": (straight(), {"type": "ConstructionObstacleTwoWays",
                                         "trigger": (40.0, 0.0, 0.0), "distance": 30.0,
                                         "frequency": (40.0, 80.0)}),
    "3_walker_behind_blocker": (straight(200), {"type": "DynamicObjectCrossing",
                                                "trigger": (30.0, 0.0, 0.0)}),
    "4_crossing_flow": (straight(200), {"type": "CrossingBicycleFlow",
                                        "trigger": (30.0, 0.0, 0.0), **_flow(60.0)}),
    "4_junction_turn": (l_shaped(), {"type": "SignalizedJunctionLeftTurn",
                                     "trigger": (80.0, 0.0, 0.0), "flow_speed": 9.0,
                                     "source_dist_interval": (15.0, 25.0)}),
    "5_opens_door": (straight(), {"type": "VehicleOpensDoorTwoWays",
                                  "trigger": (40.0, 0.0, 0.0), "distance": 30.0}),
    "6_pedestrian_crossing": (straight(200), {"type": "PedestrianCrossing",
                                              "trigger": (30.0, 0.0, 0.0)}),
    "7_merge_flow": (straight(), {"type": "MergerIntoSlowTrafficV2",
                                  "trigger": (40.0, 0.0, 0.0), **_flow(70.0)}),
    "8_blocked_intersection": (straight(200), {"type": "BlockedIntersection",
                                               "trigger": (30.0, 0.0, 0.0)}),
    "9_side_lane": (straight(), {"type": "HazardAtSideLane", "trigger": (20.0, 0.0, 0.0)}),
    "10_adversary": (l_shaped(), {"type": "OppositeVehicleTakingPriority",
                                  "trigger": (85.0, 0.0, 0.0), "direction": "right"}),
    "10_adversary_walker": (l_shaped(), {"type": "VehicleTurningRoutePedestrian",
                                         "trigger": (60.0, 0.0, 0.0)}),
    "11_emergency": (straight(400), {"type": "YieldToEmergencyVehicle",
                                     "trigger": (6.0, 0.0, 0.0), "distance": 25.0}),
    "12_hard_brake": (straight(400), {"type": "HardBreakRoute", "trigger": (20.0, 0.0, 0.0)}),
    "13_control_loss": (straight(400), {"type": "ControlLoss", "trigger": (20.0, 0.0, 0.0)}),
}
NAMES = list(FAMILIES)
REAL = [f"real_{r}" for r in seen_routes()[:3]]
STEPS = 200
TICKS = (0, 50, 100, 150, 199)  # states injected from these ticks of the JAX run
OPEN_LOOP = 50
CRAFTED = ["vehicle_hit", "walker_hit", "static_hit", "same_vehicle_again"]


@functools.lru_cache(maxsize=None)
def driven():
    """The families and three real routes driven by the JAX expert for
    STEPS ticks (key=None stepping): specs, reset keys, the reset states
    and every tick's state [W, T, ...] and action [W, T, 7]."""
    real = load_benchmark_specs(None, seen_routes()[:3])
    sp = jax.tree.map(jnp.asarray, stack_specs(
        [build_world_spec({"id": i, "town": "T", "waypoints": w, "scenarios": [s],
                           "weather": [0, 0, 0, 90]})
         for i, (w, s) in enumerate(FAMILIES.values())]
        + [jax.tree.map(lambda a: a[i], real) for i in range(3)]))
    keys = jax.random.split(jax.random.PRNGKey(0), len(NAMES) + len(REAL))
    env = DrivingEnv()

    def run(spec, key):
        def body(s, _):
            a = expert_action(spec, s)
            s = env.step(spec, s, a)
            return s, (s, a)
        s0 = env.reset(spec, key)
        return s0, jax.lax.scan(body, s0, None, length=STEPS)[1]

    reset, (states, actions) = jax.jit(jax.vmap(run))(sp, keys)
    return sp, keys, reset, states, np.asarray(actions)


def _pick(tree, idx):
    return jax.tree.map(lambda a: np.asarray(a)[idx], tree)


def test_reset_matches():
    sp, _, reset, _, _ = driven()
    assert_states_close(reset, PortEnv().reset(port_spec(sp)), rtol=0, atol=0)


@pytest.fixture(scope="module")
def stepped():
    """The port steps each injected state (the state after t ticks) with
    JAX's action and draws of tick t; JAX's own next state is the reference."""
    sp, keys, reset, states, actions = driven()
    n = len(NAMES)
    # [W, 1 + T, ...]: index t is the state after t ticks
    before = jax.tree.map(lambda r, d: np.concatenate([np.asarray(r)[:, None], np.asarray(d)], 1),
                          reset, states)
    draws = rollout_draws(keys, STEPS)  # [T, W, 4]
    w = [i for t in TICKS for i in range(n)]
    t = [t for t in TICKS for _ in range(n)]
    got = PortEnv().step(port_spec(_pick(sp, w)), port_state(_pick(before, (w, t))),
                         torch.from_numpy(actions[w, t]), torch.from_numpy(draws[t, w]))
    return np.asarray([NAMES[i] for i in w]), _pick(states, (w, t)), got


@pytest.mark.parametrize("family", NAMES)
def test_step_matches(stepped, family):
    names, ref, got = stepped
    assert_states_close(ref, got, rows=names == family)


def test_scenarios_ran():
    """The injected states cover the scenario phases, not only waiting."""
    phase = np.asarray(driven()[3].scenario.phase)[:, -1, 0]
    by = dict(zip(NAMES, phase))
    for fam in ("1_cut_in", "3_walker_behind_blocker", "6_pedestrian_crossing",
                "8_blocked_intersection", "9_side_lane", "11_emergency", "12_hard_brake",
                "13_control_loss"):
        assert by[fam] >= 1, fam


def crafted():
    """Collision states on the passive route after 60 ticks, ego at 5 m/s: a
    vehicle, a walker, a static prop overlapping the ego, and the last
    event's vehicle still in contact within the dedup window."""
    st = _pick(driven()[3], (0, 60))
    ego = np.asarray(st.ego.pos)
    ahead = ego + np.array([3.0, 0.0], np.float32)
    out = []
    for name in CRAFTED:
        s = jax.tree.map(np.array, st)
        s.ego.speed[...] = 5.0
        s.ego.yaw[...] = 0.0
        if name in ("vehicle_hit", "same_vehicle_again"):
            s.vehicles.pos[2] = ahead
            s.vehicles.alive[2] = True
            s.vehicles.half_extent[2] = [2.3, 0.9]
        if name == "same_vehicle_again":
            s.criteria.last_collision_id[...] = 2
            s.criteria.last_collision_gen[...] = s.vehicles.gen[2]
            s.criteria.last_collision_time[...] = s.t * 0.05 - 0.5
        if name == "walker_hit":
            s.walkers.pos[0] = ego + np.array([2.6, 0.0], np.float32)
            s.walkers.alive[0] = True
            s.walkers.ttl[0] = 10.0
        if name == "static_hit":
            s.statics.pos[8] = ahead
            s.statics.alive[8] = True
            s.statics.half_extent[8] = [1.0, 1.0]
        out.append(s)
    return jax.tree.map(lambda *c: np.stack(c), *out)


def test_crafted_collisions_match():
    """criteria_step on the collision states: same counts and dedup state."""
    sp = driven()[0]
    spec = _pick(sp, [0] * len(CRAFTED))
    st = crafted()
    ref = jax.vmap(JC.criteria_step)(jax.tree.map(jnp.asarray, spec), jax.tree.map(jnp.asarray, st))
    got = PC.criteria_step(port_spec(spec), port_state(st))
    assert_states_close(ref, got)
    cv = got.criteria.collisions_vehicle.numpy()
    before = np.asarray(st.criteria.collisions_vehicle)
    assert cv[0] == before[0] + 1 and cv[3] == before[3]  # the repeat is deduplicated
    assert got.criteria.collisions_pedestrian[1] == int(st.criteria.collisions_pedestrian[1]) + 1
    assert got.criteria.collisions_static[2] == int(st.criteria.collisions_static[2]) + 1


def test_decode_action_nan_guard():
    a = torch.tensor([[float("nan"), float("inf"), 0.9, 0, 0, 0, 0],
                      [2.0, -float("inf"), 0.5, 0, 0, 0, 0]])
    th, st, br = decode_action(a)
    assert th.tolist() == [0.0, 1.0] and st.tolist() == [1.0, -1.0] and br.tolist() == [1.0, 0.0]


def test_open_loop_rollout_scores_match():
    """Three real routes, OPEN_LOOP ticks of JAX's actions and draws."""
    sp, keys, _, states, actions = driven()
    real = list(range(len(NAMES), len(NAMES) + len(REAL)))
    draws = rollout_draws(keys, OPEN_LOOP)[:, real]
    spec_p = port_spec(_pick(sp, real))
    env = PortEnv()
    st = env.reset(spec_p)
    for t in range(OPEN_LOOP):
        st = env.step(spec_p, st, torch.from_numpy(actions[real, t]), torch.from_numpy(draws[t]))
    ref = _pick(states, (real, OPEN_LOOP - 1))
    want = jax.vmap(compute_score)(jax.tree.map(jnp.asarray, _pick(sp, real)),
                                   jax.tree.map(jnp.asarray, ref))
    got = PC.compute_score(spec_p, st)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert_states_close(ref, st, rtol=1e-4, atol=1e-4)
    assert float(np.asarray(want["score_route"]).max()) > 0.0  # the routes were driven


def test_polyline_point_matches():
    """dynamics.polyline_point against the JAX one on a real route, with
    arclengths inside, at the ends and beyond both ends (clamped)."""
    from gabril_carla_tpu.env.dynamics import polyline_point as jax_point
    from gabril_carla_tpu_torch.env.dynamics import polyline_point

    sp = _pick(driven()[0], len(NAMES))
    n = int(sp.n_route)
    s = np.array([-3.0, 0.0, 0.4, 17.25, n - 1.5, n - 1.0, n + 40.0], np.float32)
    want_p, want_d = jax.vmap(lambda x: jax_point(jnp.asarray(sp.route_xy), jnp.asarray(sp.route_dir),
                                                  x, sp.n_route))(jnp.asarray(s))
    got_p, got_d = polyline_point(torch.from_numpy(sp.route_xy[None]), torch.from_numpy(sp.route_dir[None]),
                                  torch.from_numpy(s[None]), torch.tensor([n]))
    np.testing.assert_allclose(got_p[0].numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got_d[0].numpy(), np.asarray(want_d))
