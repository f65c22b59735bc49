"""Port parity: the render kernel's row classes and its two variants
(ops/render_kernel.py: pixel_classes, row_sets; ops/raster.py:
_pallas_inputs(far_decimate=...)).

Against the JAX package, on scenes chosen so that each branch of the TPU
kernel's gates runs (pallas_raster.py:188-229, :288-291):
  * the per-pixel class map against a numpy restatement of
    pallas_raster.py:184-186, for all 57,600 pixels;
  * the far-decimated operands, rtol 1e-5 / atol 1e-5 (as
    tests/test_torch_render.py), and the row accounting of
    tests/test_far_decimate.py on the port;
  * the plain version against the TPU kernel (render_frame_pallas in
    interpret mode) on identical operands, for all four (far_decimate,
    lower_window) combinations, at the tests/test_raster.py bar: fewer than
    1% of pixels off by more than 1e-3 and a median difference below 1e-5;
  * a short CPU rollout with lower_window against the default one's frames,
    at the same bar.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.ops.raster as JR
import gabril_carla_tpu_torch.ops.raster as TR
from gabril_carla_tpu.env import DrivingEnv
from gabril_carla_tpu.env.world import build_world_spec
from gabril_carla_tpu.ops.pallas_raster import (BLOCK_ROWS, CAP3_DECIMATED, LANES, NEAR_PREFIX,
                                                render_frame_pallas)
from gabril_carla_tpu_torch.ops import render_kernel as K
from test_torch_common import port_spec, port_state
from test_torch_render import assert_frames_match

STRAIGHT = np.stack([np.arange(0.0, 200.0, 2.0), np.zeros(100)], 1).astype(np.float32)
SINE = np.stack([np.arange(0.0, 200.0, 2.0), 8 * np.sin(np.arange(100) * 0.06)], 1).astype(np.float32)
LOOP = np.stack([7.0 * np.cos(np.linspace(0, 6 * np.pi, 120)),
                 7.0 * np.sin(np.linspace(0, 6 * np.pi, 120))], 1).astype(np.float32)


def _world(wps, idx, pos=None, scenarios=(), ambient=True):
    """A route compiled by the JAX package, its ego moved to route point
    ``idx`` (1 m spacing) facing along the route, or to ``pos``."""
    spec = jax.tree.map(jnp.asarray, build_world_spec(
        {"id": 1, "town": "T", "waypoints": wps, "scenarios": list(scenarios),
         "weather": [5, 0, 2, 90]}, ambient=ambient))
    st = DrivingEnv().reset(spec, jax.random.PRNGKey(0))
    xy = spec.route_xy[idx] if pos is None else jnp.asarray(pos)
    d = spec.route_dir[idx]
    return spec, st.replace(ego=st.ego.replace(pos=xy, yaw=jnp.arctan2(d[1], d[0]),
                                               route_idx=jnp.asarray(idx, jnp.int32)))


def crowded():
    """More than 24 visible boxes: a grid of vehicles and a row of walkers
    ahead of the camera (tests/test_raster.py:240)."""
    spec, st = _world(STRAIGHT, 30)
    veh, wk = st.vehicles, st.walkers
    k = min(veh.pos.shape[0], 30)
    pos, alive = np.asarray(veh.pos).copy(), np.asarray(veh.alive).copy()
    pos[:k] = np.stack([42.0 + 4.0 * (np.arange(k) % 6), -6.0 + 2.5 * (np.arange(k) // 6)], 1)
    alive[:k] = True
    wpos, walive = np.asarray(wk.pos).copy(), np.asarray(wk.alive).copy()
    wpos[:6] = np.stack([44.0 + 3.0 * np.arange(6), np.full(6, 3.0)], 1)
    walive[:6] = True
    return spec, st.replace(vehicles=veh.replace(pos=jnp.asarray(pos), alive=jnp.asarray(alive)),
                            walkers=wk.replace(pos=jnp.asarray(wpos), alive=jnp.asarray(walive)))


# name -> (scene, the cam slots that show the branch it drives)
SCENES = {
    # the route curls around the ego: class 0 overflows its 56-row prefix
    # and takes every row (tests/test_raster.py:214)
    "tight_loop": (lambda: _world(LOOP, 40, pos=[7.0, 0.0]), lambda c: c[11] > NEAR_PREFIX[0]),
    "crowded": (crowded, lambda c: c[15] > 24),
    # no crossing flow: the valid rows fit the class-3 cap (tests/test_raster.py:271)
    "flowless": (lambda: _world(STRAIGHT, 0, ambient=False), lambda c: c[14] <= 128.5),
    # mid-route: both lower counts cover their skipped rows
    "lower_window_on": (lambda: _world(STRAIGHT, 30), lambda c: c[16] >= 12 and c[17] >= 44),
    # at the route's start few rows lie behind the camera: neither does
    "lower_window_off": (lambda: _world(STRAIGHT, 0), lambda c: c[16] < 12 and c[17] < 44),
    # far rows beyond 40 m on a curve (tests/test_far_decimate.py's route)
    "sine": (lambda: _world(SINE, 40, scenarios=[
        {"type": "PedestrianCrossing", "trigger": (40.0, 0.5, 0.0)}]),
        lambda c: c[14] <= 128.5),
    # with a live crossing flow the valid rows overflow the class-3 cap,
    # which then takes every row
    "sine_flow": (lambda: _world(SINE, 40, scenarios=[
        {"type": "CrossingBicycleFlow", "trigger": (40.0, 0.0, 0.0),
         "start_actor_flow": (60.0, 30.0), "end_actor_flow": (60.0, -30.0),
         "flow_speed": 8.0, "source_dist_interval": (10.0, 20.0)}]),
        lambda c: c[14] > 128.5),
}
FLAGS = list(itertools.product((False, True), repeat=2))  # (far_decimate, lower_window)


@functools.lru_cache(maxsize=None)
def scene(name):
    return SCENES[name][0]()


@functools.lru_cache(maxsize=None)
def jax_ops(name, far_decimate):
    spec, st = scene(name)
    cam, fwd, right = JR._camera_basis(st.ego.pos, st.ego.yaw)
    boxes = jnp.concatenate([JR._collect_actor_boxes(st, cam, fwd, right),
                             JR._signal_boxes(spec, st, cam, fwd, right)])
    ops = JR._pallas_inputs(spec, st, cam, fwd, right, boxes, JR.weather_now(spec, st),
                            far_decimate=far_decimate)
    return [np.asarray(o) for o in ops]


def port_ops(name, far_decimate):
    spec, st = scene(name)
    pspec = port_spec(jax.tree.map(lambda a: np.asarray(a)[None], spec))
    pst = port_state(jax.tree.map(lambda a: np.asarray(a)[None], st))
    cam, fwd, right = TR._camera_basis(pst.ego.pos, pst.ego.yaw)
    boxes = torch.cat([TR._collect_actor_boxes(pst, cam, fwd, right),
                       TR._signal_boxes(pspec, pst, cam, fwd, right)], 1)
    return TR._pallas_inputs(pspec, pst, cam, fwd, right, boxes, TR.weather_now(pspec, pst),
                             far_decimate=far_decimate)


def test_pixel_classes_match_tpu_tiles():
    """pallas_raster.py:184-186 at the default tile: tile i of the
    bottom-first layout is class 0 below t0, 1 below t1, 2 below t2, else 3."""
    bpx = BLOCK_ROWS * LANES
    t0, t1, t2 = 8192 // bpx, 16384 // bpx, 24576 // bpx
    v, u = np.meshgrid(np.arange(180), np.arange(320), indexing="ij")
    tile = ((179 - v) * 320 + u) // bpx
    want = np.where(tile < t0, 0, np.where(tile < t1, 1, np.where(tile < t2, 2, 3)))
    got = K.pixel_classes().numpy()
    assert got.shape == (180, 320)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_drives_its_branch(name):
    assert SCENES[name][1](jax_ops(name, False)[0]), jax_ops(name, False)[0][11:18]


@pytest.mark.parametrize("name", list(SCENES))
def test_far_decimated_operands_match(name):
    for label, got, want in zip(("cam_scalars", "route_cols", "boxes"), port_ops(name, True),
                                jax_ops(name, True)):
        np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-5, err_msg=label)


def test_row_accounting_and_endpoint_exemption():
    """tests/test_far_decimate.py::test_row_accounting_and_endpoint_exemption
    on the port: the dropped rows are exactly the odd-index route rows
    beyond 40 m that are not the window's end, and the rest fit the
    decimated class-3 cap."""
    cs0, _, _ = port_ops("sine", False)
    cs1, cols1, _ = port_ops("sine", True)
    ops0 = jax_ops("sine", False)[1]
    n0, n1 = float(cs0[0, 14]), float(cs1[0, 14])
    assert n1 < n0
    cols1 = cols1[0].numpy()
    live = cols1[cols1[:, 2] < 1e11]
    route = live[live[:, 6] < TR.ROUTE_VIEW]
    far = route[route[:, 2] > TR.FAR_DECIMATE_R2]
    j = far[:, 6].astype(int)
    spec, st = scene("sine")
    start = int(np.clip(int(st.ego.route_idx) - TR.ROUTE_BEHIND, 0,
                        spec.route_xy.shape[0] - TR.ROUTE_VIEW))
    n_valid_route = int(np.clip(int(spec.n_route) - start, 1, TR.ROUTE_VIEW))
    assert len(j) and ((j % 2 == 0) | (j == n_valid_route - 1)).all()
    # every dropped row is an odd, far, non-endpoint valid route row
    valid0 = ops0[ops0[:, 2] < 1e11]
    dropped = set(valid0[:, 6].astype(int)) - set(live[:, 6].astype(int))
    far0 = {int(r[6]) for r in valid0 if r[6] < TR.ROUTE_VIEW and r[2] > TR.FAR_DECIMATE_R2}
    assert dropped and dropped == {i for i in far0 if i % 2 == 1 and i != n_valid_route - 1}
    assert n0 - n1 == len(dropped)
    assert n1 <= CAP3_DECIMATED + 0.5, n1


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: f"fd{int(f[0])}-lw{int(f[1])}")
@pytest.mark.parametrize("name", list(SCENES))
def test_plain_matches_tpu_kernel_with_flags(name, flags):
    far_decimate, lower_window = flags
    cam, cols, boxes = jax_ops(name, far_decimate)
    tpu = np.asarray(render_frame_pallas(
        jnp.asarray(cam), jnp.asarray(cols), jnp.asarray(boxes), cols.shape[0], boxes.shape[0],
        JR.ROUTE_VIEW, interpret=True, far_decimate=far_decimate, lower_window=lower_window))
    plain = K.render_from_operands(*(torch.from_numpy(o.copy())[None] for o in (cam, cols, boxes)),
                                   far_decimate=far_decimate, lower_window=lower_window)
    print(f"{name} {flags}: max abs error {np.abs(plain[0].numpy() - tpu).max():.3g}")
    assert_frames_match(plain[0].numpy(), tpu)


def test_lower_window_rollout_matches_default():
    """A short CPU rollout on the tight loop (where class 3's lower window
    engages from the first frame) and a straight route: frames with
    lower_window against the default's, frame by frame."""
    from gabril_carla_tpu_torch.env.world import build_world_spec as port_build, stack_specs, to_torch
    from gabril_carla_tpu_torch.eval.rollout import make_rollout_fn
    from gabril_carla_tpu_torch.train.bc import build_bc_models, init_bc_params, make_bc_policy_fn
    from gabril_carla_tpu_torch.utils.config import default_bc_config

    cfg = default_bc_config()
    cfg["gaze"]["method"] = "None"
    cfg["model"].update(num_hiddens=8, embedding_dim=8, z_dim=16, num_residual_hiddens=4)
    models = build_bc_models(cfg, device="cpu")
    from gabril_carla_tpu_torch.utils.prng import prng_key, split

    params = init_bc_params(models, cfg, prng_key(0))
    spec = to_torch(stack_specs([port_build({"id": i, "town": "T", "waypoints": w, "scenarios": [],
                                             "weather": [0, 0, 0, 90]})
                                 for i, w in enumerate((LOOP, STRAIGHT))]), "cpu")
    keys = split(prng_key(1), 2)
    frames = {}
    for lw in (False, True):
        fn = make_rollout_fn(make_bc_policy_fn(models, cfg), cfg, steps=4, return_frames=True,
                             lower_window=lw)
        st, frames[lw] = fn(spec, params, keys)
    cam = TR._pallas_inputs(spec, st, *TR._camera_basis(st.ego.pos, st.ego.yaw),
                            torch.zeros(2, 1, 8), TR.weather_now(spec, st))[0]
    assert cam[0, 17] >= 44 and cam[0, 14] <= 128.5  # the gate engaged on the loop
    for a, b in zip(frames[True].flatten(0, 1), frames[False].flatten(0, 1)):
        assert_frames_match(a.numpy(), b.numpy())


@pytest.mark.parametrize("far_decimate", (False, True))
def test_row_sets_follow_the_gates(far_decimate):
    """Each class's count gate on crafted camera slots: the prefix when the
    count fits, every row when it overflows, and with lower_window the 4
    endpoint rows plus [12, n2) or [44, cap3) when the lower count covers
    the skipped rows (pallas_raster.py:188-229)."""
    n2, cap3 = (88, 96) if far_decimate else (120, 128)
    fits = torch.zeros(18)
    fits[11:15] = torch.tensor([56.0, 72.0, n2, cap3 + 0.5])
    fits[16:18] = torch.tensor([12.0, 44.0])
    over = fits.clone()
    over[11:15] += 1.0
    short = fits.clone()
    short[16:18] -= 1.0
    cam = torch.stack([fits, over, short])

    def sizes(lower_window):
        return K.row_sets(cam, 160, far_decimate=far_decimate, lower_window=lower_window).sum(-1)

    assert sizes(False).tolist() == [[56, 72, n2, cap3], [160] * 4, [56, 72, n2, cap3]]
    assert sizes(True).tolist() == [[56, 72, 4 + n2 - 12, 4 + cap3 - 44], [160] * 4,
                                    [56, 72, n2, cap3]]
    windows = K.row_sets(cam[:1], 160, far_decimate=far_decimate, lower_window=True)[0]
    assert windows[2, :4].all() and not windows[2, 4:12].any() and windows[2, 12:n2].all()
    assert windows[3, :4].all() and not windows[3, 4:44].any() and not windows[3, cap3:].any()
    # every bound is capped at the row count
    assert K.row_sets(cam, 40, far_decimate=far_decimate).sum(-1).max() == 40


def test_wrapper_rejects_non_bool_flags():
    cam, rows, boxes = torch.zeros(1, 18), torch.zeros(1, 160, 8), torch.zeros(1, 32, 8)
    with pytest.raises(TypeError):
        K.render_from_operands(cam, rows, boxes, far_decimate=1)
    with pytest.raises(TypeError):
        K.render_from_operands(cam, rows, boxes, lower_window="yes")
