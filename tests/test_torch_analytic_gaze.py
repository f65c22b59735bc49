"""Port parity: analytic scene-graph gaze and the confounded overlay
(ops/raster.py analytic_gaze, confounded_overlay), batched over worlds,
against the JAX package's per-world functions vmapped.

The 20 real routes at reset and after DRIVEN ticks of the JAX expert, the
port stepped with the same actions and JAX's replayed draws: coordinates
within 1e-5 of JAX's on the JAX state converted to the port, and within 1e-4
on the port's own driven state (its positions follow JAX's to ~1e-5 m,
tests/test_torch_env.py), with the same invalid (-1) slots. Both
``curvature_anticipation`` modes. The hazard ordering of
tests/test_raster.py's crossing-versus-parked scene; the overlay bitwise;
the analytic heat against JAX's GazeHeatmapper.heatmaps within 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.ops.raster as JR
from gabril_carla_tpu.data.tasks import seen_routes, unseen_routes
from gabril_carla_tpu.env.env import DrivingEnv
from gabril_carla_tpu.env.expert import expert_action
from gabril_carla_tpu.env.world import build_world_spec, load_benchmark_specs
from gabril_carla_tpu.ops.heatmap import GazeHeatmapper as JHeatmapper
from gabril_carla_tpu_torch.env.env import DrivingEnv as PortEnv
from gabril_carla_tpu_torch.env.world import build_world_spec as port_world_spec
from gabril_carla_tpu_torch.env.world import stack_specs, to_torch
from gabril_carla_tpu_torch.ops import raster as PR
from gabril_carla_tpu_torch.ops.heatmap import GazeHeatmapper
from test_torch_common import port_spec, port_state, rollout_draws

DRIVEN = 40
P = 5


@functools.lru_cache(maxsize=None)
def driven():
    """The 20 real routes: specs, reset keys, reset states, the states after
    DRIVEN expert ticks and the actions [W, T, 7]."""
    sp = jax.tree.map(jnp.asarray, load_benchmark_specs(None, seen_routes() + unseen_routes()))
    keys = jax.random.split(jax.random.PRNGKey(7), 20)
    env = DrivingEnv()

    def run(spec, key):
        def body(s, _):
            a = expert_action(spec, s)
            return env.step(spec, s, a), a
        s0 = env.reset(spec, key)
        s, actions = jax.lax.scan(body, s0, None, length=DRIVEN)
        return s0, s, actions

    reset, final, actions = jax.jit(jax.vmap(run))(sp, keys)
    return sp, keys, reset, final, np.asarray(actions)


@functools.lru_cache(maxsize=None)
def jax_gaze(which: str, curv: bool) -> np.ndarray:
    sp, _, reset, final, _ = driven()
    st = reset if which == "reset" else final
    # op by op: under jit XLA contracts products into FMAs, which moves the
    # curvature mode's road point by up to 6.1e-5 (measured at reset); op by
    # op, the port agrees to 6e-8
    fn = jax.vmap(lambda s, x: JR.analytic_gaze(s, x, P, curvature_anticipation=curv))
    return np.asarray(fn(sp, st))


@functools.lru_cache(maxsize=None)
def port_driven():
    sp, keys, _, _, actions = driven()
    spec = port_spec(jax.tree.map(np.asarray, sp))
    draws = rollout_draws(keys, DRIVEN)
    env = PortEnv()
    st = env.reset(spec)
    for t in range(DRIVEN):
        st = env.step(spec, st, torch.from_numpy(actions[:, t].copy()),
                       torch.from_numpy(draws[t]))
    return spec, st


def assert_gaze_close(got, want, atol):
    assert got.shape == want.shape == (20, 2 * P)
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("curv", [False, True], ids=["fixed", "curvature"])
@pytest.mark.parametrize("which", ["reset", "driven"])
def test_analytic_gaze_matches_jax(which, curv):
    sp, _, reset, final, _ = driven()
    want = jax_gaze(which, curv)
    spec = port_spec(jax.tree.map(np.asarray, sp))
    st = port_state(reset if which == "reset" else final)
    got = PR.analytic_gaze(spec, st, P, curvature_anticipation=curv).numpy()
    assert_gaze_close(got, want, 1e-5)
    assert (want[:, 2:] >= 0).sum() > 10  # actors were picked
    if which == "driven":
        spec_p, st_p = port_driven()
        got = PR.analytic_gaze(spec_p, st_p, P, curvature_anticipation=curv).numpy()
        assert_gaze_close(got, want, 1e-4)


def test_curvature_moves_the_road_point():
    fixed, curv = jax_gaze("driven", False), jax_gaze("driven", True)
    assert not np.array_equal(fixed[:, :2], curv[:, :2])
    np.testing.assert_array_equal(fixed[:, 2:], curv[:, 2:])


def _hazard_scene(port: bool):
    """tests/test_raster.py:176-205: a parked car 12 m ahead and slightly
    right, a crossing car 30 m ahead closing at 10 m/s from the left."""
    wps = np.stack([np.arange(0.0, 200, 2.0), np.zeros(100)], 1).astype(np.float32)
    route = {"id": 1, "town": "T", "waypoints": wps, "scenarios": [], "weather": [0, 0, 0, 90]}
    if not port:
        spec = jax.tree.map(jnp.asarray, build_world_spec(route))
        st = DrivingEnv().reset(spec, jax.random.PRNGKey(0))
        st = st.replace(ego=st.ego.replace(pos=jnp.asarray([0.0, 0.0]), speed=jnp.asarray(6.0)))
        v = st.vehicles
        alive = jnp.zeros_like(v.alive).at[0].set(True).at[1].set(True)
        pos = v.pos.at[0].set(jnp.asarray([12.0, 2.5])).at[1].set(jnp.asarray([30.0, -12.0]))
        v = v.replace(pos=pos,
                      yaw=v.yaw.at[1].set(jnp.asarray(np.pi / 2)), speed=v.speed.at[1].set(10.0),
                      alive=alive)
        return np.asarray(JR.analytic_gaze(spec, st.replace(vehicles=v), max_points=2))
    spec = to_torch(stack_specs([port_world_spec(route)]), "cpu")
    st = PortEnv().reset(spec)
    st = st.replace(ego=st.ego.replace(pos=torch.zeros(1, 2), speed=torch.full((1,), 6.0)))
    v = st.vehicles
    pos, yaw, speed = v.pos.clone(), v.yaw.clone(), v.speed.clone()
    alive = torch.zeros_like(v.alive)
    alive[0, :2] = True
    pos[0, 0], pos[0, 1] = torch.tensor([12.0, 2.5]), torch.tensor([30.0, -12.0])
    yaw[0, 1], speed[0, 1] = float(np.float32(np.pi / 2)), 10.0
    v = v.replace(pos=pos, yaw=yaw, speed=speed, alive=alive)
    return PR.analytic_gaze(spec, st.replace(vehicles=v), max_points=2)[0].numpy()


def test_hazard_prefers_closing_crosser_over_near_parked():
    got, want = _hazard_scene(port=True).reshape(-1, 2), _hazard_scene(port=False).reshape(-1, 2)
    assert 0 <= got[1, 0] < 0.5, got  # the crossing car, on the driver's left
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_confounded_overlay_bitwise():
    rng = np.random.default_rng(0)
    img = rng.random((6, 180, 320), dtype=np.float32)
    act = np.zeros((6, 7), np.float32)
    act[:, 1] = [-1.5, -0.3, 0.0, 0.7, 2.0, 0.25]  # steer, clipped to [-1, 1]
    act[:, 2] = [1.0, 0.0, 0.81, 0.8, 0.5, 0.95]  # brake dot above 0.8
    want = np.asarray(jax.vmap(JR.confounded_overlay)(jnp.asarray(img), jnp.asarray(act)))
    got = PR.confounded_overlay(torch.from_numpy(img), torch.from_numpy(act)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 1.0).sum() > 20 and (got == np.float32(0.95)).sum() > 20


def test_analytic_heat_matches_jax():
    """The rollout's analytic heat: JAX's coordinates after DRIVEN ticks
    splatted by both heatmappers at 180x320 (rollout.py:76-80's settings)."""
    coords = jax_gaze("driven", False)
    want = np.asarray(JHeatmapper(img_height=180, img_width=320, gaze_sigma=30.0,
                                  maxpoints=P).heatmaps(jnp.asarray(coords)))
    got = GazeHeatmapper(img_height=180, img_width=320, gaze_sigma=30.0,
                         maxpoints=P).heatmaps(torch.from_numpy(coords)).numpy()
    assert got.shape == (20, 180, 320) and 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
