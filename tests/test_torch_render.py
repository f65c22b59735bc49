"""Port parity: the camera renderer (ops/raster.py, ops/render_kernel.py).

Against the JAX package on the scenes of tests/test_raster.py and on three
real routes:
  * the kernel operands (_pallas_inputs): columns, camera slots and
    compacted boxes, rtol 1e-5 / atol 1e-5 (relative: c3 = |q|^2 reaches
    1e4 m^2, and 1e12 on invalid rows);
  * the plain version against the TPU kernel itself (render_frame_pallas
    in interpret mode) on the same operands, and the port's render_frame
    against the JAX render_frame (its XLA oracle on the CPU), both at the
    tests/test_raster.py bar: fewer than 1% of pixels off by more than 1e-3
    and a median difference below 1e-5.
The card tests of the CUDA kernel are in tests/test_torch_card.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.ops.raster as JR
import gabril_carla_tpu_torch.ops.raster as TR
from gabril_carla_tpu.data.tasks import seen_routes
from gabril_carla_tpu.env import DrivingEnv
from gabril_carla_tpu.env.expert import expert_action
from gabril_carla_tpu.env.world import build_world_spec, load_benchmark_specs, stack_specs
from gabril_carla_tpu.ops.pallas_raster import render_frame_pallas
from gabril_carla_tpu_torch.ops import render_kernel as K
from test_torch_common import port_spec, port_state


def _spec(route, **kw):
    return jax.tree.map(jnp.asarray, build_world_spec(route, **kw))


@functools.lru_cache(maxsize=None)
def driven():
    """test_raster's sine-route scene after 50 ticks at throttle 0.5, and
    three real routes after 50 expert-driven ticks, in one vmapped JAX run."""
    wps = np.stack([np.arange(0.0, 160, 2.0), 10 * np.sin(np.arange(80) * 0.08)], 1).astype(np.float32)
    sine = build_world_spec({"id": 1, "town": "T", "waypoints": wps, "weather": [5, 0, 2, 90],
                             "scenarios": [{"type": "PedestrianCrossing", "trigger": (30.0, 0.5, 0.0)}]})
    real = load_benchmark_specs(None, seen_routes()[:3])
    specs = jax.tree.map(jnp.asarray, stack_specs(
        [sine] + [jax.tree.map(lambda a: a[i], real) for i in range(3)]))
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    const = jnp.asarray([0.5, 0, 0, 0, 0, 0, 0], jnp.float32)
    env = DrivingEnv()

    def run(spec, k, use_const):
        def body(s, _):
            return env.step(spec, s, jnp.where(use_const, const, expert_action(spec, s))), None
        return jax.lax.scan(body, env.reset(spec, k), None, length=50)[0]

    return specs, jax.jit(jax.vmap(run))(specs, keys, jnp.arange(4) == 0)


def _world(i):
    specs, states = driven()
    return jax.tree.map(lambda a: a[i], specs), jax.tree.map(lambda a: a[i], states)


def scene():
    return _world(0)


def crossing_scene():
    wps = np.stack([np.arange(0.0, 160, 2.0), np.zeros(80)], 1).astype(np.float32)
    spec = _spec({"id": 2, "town": "T", "waypoints": wps, "weather": [0, 0, 0, 90],
                  "scenarios": [{"type": "CrossingBicycleFlow", "trigger": (40.0, 0.0, 0.0),
                                 "start_actor_flow": (60.0, -40.0), "end_actor_flow": (60.0, 40.0),
                                 "flow_speed": 8.0, "source_dist_interval": (12.0, 25.0)}]})
    st = DrivingEnv().reset(spec, jax.random.PRNGKey(0))
    return spec, st.replace(ego=st.ego.replace(pos=jnp.asarray([30.0, 0.0]),
                                               route_idx=jnp.asarray(30, jnp.int32)))


def tight_loop():
    t = np.linspace(0, 6 * np.pi, 120)
    r = 7.0
    wps = np.stack([r * np.cos(t), r * np.sin(t)], 1).astype(np.float32)
    spec = _spec({"id": 9, "town": "T", "waypoints": wps, "scenarios": [], "weather": [0, 0, 0, 90]})
    st = DrivingEnv().reset(spec, jax.random.PRNGKey(0))
    return spec, st.replace(ego=st.ego.replace(pos=jnp.asarray([r, 0.0]),
                                               route_idx=jnp.asarray(40, jnp.int32)))


def crowded():
    """test_raster's box-prefix scene: > 24 visible boxes."""
    spec, st = scene()
    veh, wk = st.vehicles, st.walkers
    k = min(veh.pos.shape[0], 30)
    pos = np.asarray(veh.pos).copy()
    pos[:k] = np.stack([12.0 + 4.0 * (np.arange(k) % 6), -6.0 + 2.5 * (np.arange(k) // 6)], 1)
    alive = np.asarray(veh.alive).copy()
    alive[:k] = True
    wpos, walive = np.asarray(wk.pos).copy(), np.asarray(wk.alive).copy()
    wpos[:6] = np.stack([14.0 + 3.0 * np.arange(6), np.full(6, 3.0)], 1)
    walive[:6] = True
    return spec, st.replace(vehicles=veh.replace(pos=jnp.asarray(pos), alive=jnp.asarray(alive)),
                            walkers=wk.replace(pos=jnp.asarray(wpos), alive=jnp.asarray(walive)))


def flow_endpoints(enabled):
    wps = np.stack([np.arange(0.0, 200.0, 2.0), np.zeros(100)], 1).astype(np.float32)
    scen = ([{"type": "CrossingBicycleFlow", "trigger": (40.0, 0.0, 0.0),
              "start_actor_flow": (60.0, 30.0), "end_actor_flow": (60.0, -30.0),
              "flow_speed": 8.0, "source_dist_interval": (10.0, 20.0)}] if enabled else [])
    spec = _spec({"id": 4, "town": "T", "waypoints": wps, "weather": [0, 0, 0, 90],
                  "scenarios": scen}, ambient=False)
    return spec, DrivingEnv().reset(spec, jax.random.PRNGKey(0))


def foggy_night():
    spec, st = scene()
    keys = np.zeros((spec.weather_keys.shape[0], 6), np.float32)
    keys[:, 0] = 100.0
    keys[0] = [0.0, 80.0, 70.0, 60.0, -30.0, 90.0]
    keys[1] = [100.0, 80.0, 70.0, 60.0, -30.0, 90.0]
    return spec.replace(weather_keys=jnp.asarray(keys), n_weather=jnp.asarray(2, jnp.int32)), st


def real_route(i):
    return lambda: _world(1 + i)


SCENES = {"scene": scene, "crossing": crossing_scene, "tight_loop": tight_loop,
          "crowded": crowded, "flowless": lambda: flow_endpoints(False),
          "flow_endpoints": lambda: flow_endpoints(True), "foggy_night": foggy_night,
          **{f"real_{i}": real_route(i) for i in range(3)}}


def _jax_ops(spec, st):
    cam, fwd, right = JR._camera_basis(st.ego.pos, st.ego.yaw)
    boxes = jnp.concatenate([JR._collect_actor_boxes(st, cam, fwd, right),
                             JR._signal_boxes(spec, st, cam, fwd, right)])
    ops = JR._pallas_inputs(spec, st, cam, fwd, right, boxes, JR.weather_now(spec, st))
    return [np.asarray(o) for o in ops]


def _batched(tree):
    return jax.tree.map(lambda a: np.asarray(a)[None], tree)


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    spec, st = SCENES[request.param]()
    return dict(spec=spec, st=st, ops=_jax_ops(spec, st),
                pspec=port_spec(_batched(spec)), pst=port_state(_batched(st)))


def _port_ops(c):
    spec, st = c["pspec"], c["pst"]
    cam, fwd, right = TR._camera_basis(st.ego.pos, st.ego.yaw)
    boxes = torch.cat([TR._collect_actor_boxes(st, cam, fwd, right),
                       TR._signal_boxes(spec, st, cam, fwd, right)], 1)
    return TR._pallas_inputs(spec, st, cam, fwd, right, boxes, TR.weather_now(spec, st))


def assert_frames_match(img, ref):
    d = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32))
    assert (d > 1e-3).mean() < 0.01, (d > 1e-3).mean()
    assert np.median(d) < 1e-5, np.median(d)


def test_operands_match(case):
    for name, got, want in zip(("cam_scalars", "route_cols", "boxes"), _port_ops(case), case["ops"]):
        np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-5, err_msg=name)


def test_plain_matches_tpu_kernel(case):
    cam, cols, boxes = case["ops"]
    tpu = render_frame_pallas(jnp.asarray(cam), jnp.asarray(cols), jnp.asarray(boxes),
                              cols.shape[0], boxes.shape[0], JR.ROUTE_VIEW, interpret=True)
    plain = K.render_from_operands_plain(*(torch.from_numpy(o)[None] for o in case["ops"]))
    assert_frames_match(plain[0].numpy(), tpu)


def test_render_frame_matches_oracle(case):
    before = K.render_kernel.launches
    img = TR.render_frame(case["pspec"], case["pst"])
    assert img.shape == (1, 180, 320) and K.render_kernel.launches == before
    assert_frames_match(img[0].numpy(), JR.render_frame(case["spec"], case["st"]))


def test_render_batches_worlds():
    """Worlds render independently: a batch of two equals each alone."""
    ops = [torch.from_numpy(np.stack([a, b]))
           for a, b in zip(_jax_ops(*scene()), _jax_ops(*crossing_scene()))]
    both = K.render_from_operands(*ops)
    for i in range(2):
        assert torch.equal(both[i], K.render_from_operands(*(o[i:i + 1] for o in ops))[0])


def test_wrapper_rejects_bad_operands():
    cam, rows, boxes = torch.zeros(1, 18), torch.zeros(1, 160, 8), torch.zeros(1, 32, 8)
    with pytest.raises(ValueError):
        K.render_from_operands(cam, rows.double(), boxes)
    with pytest.raises(ValueError):
        K.render_from_operands(cam, torch.zeros(1, 161, 8), boxes)
    with pytest.raises(ValueError):
        K.render_from_operands(cam, rows.transpose(1, 2).contiguous().transpose(1, 2), boxes)
    with pytest.raises(ValueError):
        K.render_from_operands(cam[:, :17].contiguous(), rows, boxes)
