"""Port parity for the scripted expert (env/expert.py): the port's batched
``expert_action`` against the JAX package's vmapped one.

Open loop: the JAX expert drives the 20 real routes and the six synthetic
worlds of tests/test_expert.py for SYN_TICKS ticks (jitted, one batch); the
states of every OPEN_EVERY-th tick go through both packages' expert: throttle and steer within 1e-5, brake equal. JAX's side runs op by
op (vmapped, not jitted): under jit XLA fuses the pure-pursuit arithmetic on
world coordinates of a few thousand metres into FMAs, which moves the steer
by up to 2.3e-4 (measured against JAX's own op-by-op result), while op by op
the packages agree to 2e-7.

Closed loop: a TICKS-tick expert rollout of the 20 routes on the port with
JAX's draws replayed follows JAX's jitted one: the ego trace within 1e-3 m
(tests/test_torch_rollout.py's bar), brake and the tick counts equal,
throttle and steer within JIT_TOL (the jit's FMA gap above). And the six
behaviour contracts of tests/test_expert.py run on the port as one batch of
six worlds, with the port's own draws.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabril_carla_tpu.data.tasks import seen_routes, unseen_routes
from gabril_carla_tpu.env import DrivingEnv
from gabril_carla_tpu.env.expert import expert_action as jax_expert
from gabril_carla_tpu.data.vendored import parked_tables_path, routes_path
from gabril_carla_tpu.env.world import build_world_spec, load_parked_tables, parse_routes
from gabril_carla_tpu_torch.env.criteria import compute_score
from gabril_carla_tpu_torch.env.env import DrivingEnv as PortEnv
from gabril_carla_tpu_torch.env.expert import expert_action
from gabril_carla_tpu_torch.env.state import tree_where
from test_torch_common import cpu_threads, port_spec, port_state, rollout_draws

TICKS = 100  # closed loop on the 20 real routes
SYN_TICKS = 1400  # JAX's rollout for the open-loop states
OPEN_EVERY = 20
N_REAL = 20
ACT_TOL = 1e-5
JIT_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def synthetic_routes():
    """tests/test_expert.py's six worlds (sterile: no ambient traffic), in
    its order, each with the number of ticks its contract runs."""
    def straight(length, scenarios, rid=1):
        wps = np.stack([np.arange(0.0, length, 2.0), np.zeros(length // 2)], 1).astype(np.float32)
        return {"id": rid, "town": "T", "waypoints": wps, "scenarios": scenarios,
                "weather": [0, 0, 0, 90]}

    def one(scenario="None", length=160, extra=None):
        scen = {"type": scenario, "trigger": (40.0, 0.0, 0.0)}
        scen.update(extra or {})
        return straight(length, [scen])

    return [
        (one(), 800),
        (one("VanillaNonSignalizedTurnEncounterStopsign"), 900),
        (one("AccidentTwoWays", 240, {"distance": 50.0, "frequency": (60.0, 90.0)}), 1500),
        (one("PedestrianCrossing"), 1200),
        (one("CrossingBicycleFlow", 200, {
            "start_actor_flow": (60.0, -40.0), "end_actor_flow": (60.0, 40.0),
            "flow_speed": 12.0, "source_dist_interval": (5.0, 26.0)}), 1400),
        (straight(300, [{"type": "AccidentTwoWays", "trigger": (40.0, 0.0, 0.0),
                         "distance": 50.0, "frequency": (60.0, 90.0)},
                        {"type": "BlockedIntersection", "trigger": (170.0, 0.0, 0.0)}], rid=7), 2200),
    ]


def synthetic_specs(build):
    """The six worlds stacked, every one with two scenario slots."""
    return stack([build(r, ambient=False, n_scen=2) for r, _ in synthetic_routes()])


def stack(specs):
    return type(specs[0])(**{k: np.stack([np.asarray(getattr(s, k)) for s in specs])
                             for k in vars(specs[0])})


def real_specs():
    """The 20 real routes as the JAX package's load_benchmark_specs builds
    them, with two scenario slots each (the second empty) so that they stack
    with the synthetic worlds."""
    ids = seen_routes() + unseen_routes()
    routes = parse_routes(str(routes_path()), ids)
    tables = load_parked_tables(str(parked_tables_path()))
    return stack([build_world_spec(routes[r], parked=tables.get(routes[r]["town"]), n_scen=2)
                  for r in ids])


@functools.lru_cache(maxsize=None)
def jax_expert_run():
    """JAX's jitted expert rollout of the 20 real routes and the six
    synthetic worlds (in that order; reset keys PRNGKey(0..25)), SYN_TICKS
    ticks: (specs, keys, states every tick, actions every tick)."""
    both = (real_specs(), synthetic_specs(build_world_spec))
    specs = type(both[0])(**{k: jnp.asarray(np.concatenate([getattr(s, k) for s in both]))
                             for k in vars(both[0])})
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(specs.route_len.shape[0]))
    env = DrivingEnv()

    def run(spec, key):
        def tick(s, _):
            a = jax_expert(spec, s)
            return env.step(spec, s, a), (s, a)

        return jax.lax.scan(tick, env.reset(spec, key), None, length=SYN_TICKS)[1]

    states, actions = jax.jit(jax.vmap(run))(specs, keys)
    return specs, keys, states, np.asarray(actions)


@functools.lru_cache(maxsize=None)
def open_loop():
    """(port actions, JAX's op-by-op actions, world of each row): the
    states of every OPEN_EVERY-th tick of jax_expert_run, worlds x ticks as
    one batch."""
    specs, _, states, actions = jax_expert_run()
    ticks = np.arange(0, SYN_TICKS, OPEN_EVERY)
    n = len(ticks)
    flat = jax.tree.map(lambda x: x[:, ticks].reshape((-1,) + x.shape[2:]), states)
    specs_n = jax.tree.map(lambda x: jnp.repeat(x, n, axis=0), specs)
    want = np.asarray(jax.vmap(jax_expert)(specs_n, flat))
    got = expert_action(port_spec(jax.tree.map(np.asarray, specs_n)), port_state(flat)).numpy()
    return got, want, np.repeat(np.arange(specs.route_len.shape[0]), n)


def check_open_loop(worlds):
    got, want, world = open_loop()
    rows = np.isin(world, worlds)
    got, want = got[rows], want[rows]
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=ACT_TOL)
    return want


def test_open_loop_matches_jax_on_real_routes():
    acts = check_open_loop(range(N_REAL))
    # the sampled states hold braking, full throttle and curves
    assert (acts[:, 2] == 1.0).any() and (acts[:, 0] == 1.0).any() and (np.abs(acts[:, 1]) > 0.2).any()


def test_open_loop_matches_jax_on_synthetic_worlds():
    acts = check_open_loop(range(N_REAL, N_REAL + 6))
    # braking (stop sign, walkers, bicycles) and the overtakes' steering
    assert (acts[:, 2] == 1.0).any() and (np.abs(acts[:, 1]) > 0.05).any()


def test_closed_loop_matches_jax_with_replayed_draws():
    """TICKS ticks of the port's expert and env on the 20 real routes, with
    JAX's draws, against JAX's jitted rollout (module docstring)."""
    specs, keys, states, actions = jax_expert_run()
    real = slice(0, N_REAL)
    spec = port_spec(jax.tree.map(lambda x: np.asarray(x[real]), specs))
    draws = torch.from_numpy(np.array(rollout_draws(keys[real], TICKS)))
    env = PortEnv()
    state = env.reset(spec)
    pos, acts = [], []
    for t in range(TICKS):
        a = expert_action(spec, state)
        acts.append(a)
        pos.append(state.ego.pos)
        state = env.step(spec, state, a, draws[t])
    want_pos = np.asarray(states.ego.pos[real, :TICKS])  # [B, T, 2]
    got_pos = torch.stack(pos, 1).numpy()
    assert np.abs(got_pos - want_pos).max() < 1e-3
    got_acts, want_acts = torch.stack(acts, 1).numpy(), actions[real, :TICKS]
    np.testing.assert_array_equal(got_acts[..., 2:], want_acts[..., 2:])
    np.testing.assert_allclose(got_acts[..., :2], want_acts[..., :2], rtol=0, atol=JIT_TOL)
    np.testing.assert_array_equal(state.t.numpy(), np.asarray(states.t[real, TICKS]))
    moved = np.linalg.norm(got_pos[:, -1] - got_pos[:, 0], axis=-1)
    assert np.median(moved) > 5.0


@functools.lru_cache(maxsize=None)
def port_contract_run():
    """The six worlds closed loop on the port as one batch: each world's
    state at its contract's tick count, and world 5's (pos, route_idx)
    trace. The loop ends once every world is done or past its count (a
    done world is frozen, so its state and trace stay as they are)."""
    from gabril_carla_tpu_torch.env.world import build_world_spec as port_build

    spec = port_spec(synthetic_specs(port_build))
    steps = torch.tensor([n for _, n in synthetic_routes()])
    env = PortEnv()
    state = env.reset(spec)
    final = state
    gen = torch.Generator().manual_seed(0)
    trace = []
    for t in range(int(steps.max())):
        state = env.step(spec, state, expert_action(spec, state), torch.rand((6, 4), generator=gen))
        final = tree_where(steps == t + 1, state, final)
        trace.append((state.ego.pos[5].clone(), int(state.ego.route_idx[5])))
        if bool((state.done | (steps <= t + 1)).all()):
            final = tree_where(steps > t + 1, state, final)
            break
    return spec, final, compute_score(spec, final), trace


def test_expert_contracts_closed_loop():
    """tests/test_expert.py's contracts on the port, worlds 0-4: a clean
    route completed at 100; the stop sign obeyed; the accident overtaken
    without a static collision; pedestrians yielded to; the dense bicycle
    flow crossed without a collision."""
    _, final, sc, _ = port_contract_run()
    sc = {k: v.numpy() for k, v in sc.items()}
    assert sc["score_composed"][0] == 100.0
    assert sc["stop_infraction"][1] == 0 and sc["score_route"][1] == 100.0
    assert bool(final.criteria.stop_done[1].any())
    assert sc["score_route"][2] == 100.0 and sc["collisions_static"][2] == 0
    assert sc["collisions_pedestrian"][3] == 0 and sc["score_route"][3] == 100.0
    assert sc["collisions_vehicle"][4] == 0 and sc["score_route"][4] > 70.0


def test_overtake_gate_scoped_to_twoways_slot():
    """World 5: the BlockedIntersection blocker is waited out in the ego's
    own lane; the accident of the TwoWays slot is overtaken."""
    spec, _, sc, trace = port_contract_run()
    assert float(sc["score_route"][5]) == 100.0 and int(sc["collisions_vehicle"][5]) == 0
    pos = torch.stack([p for p, _ in trace]).numpy()
    idx = np.asarray([i for _, i in trace])
    tang = spec.route_dir[5].numpy()[idx]
    delta = pos - spec.route_xy[5].numpy()[idx]
    lat = delta[:, 0] * tang[:, 1] - delta[:, 1] * tang[:, 0]
    assert not np.any((lat > 1.2) & (idx > 140))
    assert np.any((lat > 1.2) & (idx > 40) & (idx < 140))
