"""Camera renderer: 320x180 fov-60 grayscale front view from the scene graph.

Port of the render path of gabril_carla_tpu/ops/raster.py. The scene is
reduced per world to three small operands (``_pallas_inputs``, named after
the JAX function it mirrors): camera/weather scalars, the distance-sorted
route and flow rows of the terrain field in camera-relative coordinates,
and the 32 nearest visible screen boxes. ``render_frame`` hands them to
ops/render_kernel.py, which runs the CUDA kernel on CUDA tensors and its
plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

import torch

from ..env import constants as C
from ..env.traffic_lights import GREEN, RED, YELLOW, light_state
from .render_kernel import CAM_Z, CX, CY, FX, MAX_DEPTH, ROUTE_VIEW, H, W, render_from_operands

CAM_FWD = 0.7  # m ahead of ego origin

COL_CAR, COL_BIKE, COL_WALKER, COL_STATIC = 0.55, 0.48, 0.70, 0.38
COL_POLE, COL_LAMP_ON, COL_LAMP_OFF, COL_STOP_SIGN = 0.30, 0.95, 0.12, 0.92

ROUTE_BEHIND = 16
FLOW_VIEW = 32  # scenario flow polyline entries appended to the terrain field
FLOW_STRIDE = 4
K_BOX = 32  # the K nearest visible boxes are composited
_INTERP_EPS = 2.0 ** -46  # np.spacing(float32 eps), jnp.interp's zero-width test

# Row-count thresholds the kernel's depth-class prefixes are validated
# against (cam slots 11-14 and 16-17; render_kernel.row_sets): a class whose
# ground reaches z_max has every output-relevant winner within
# 1.154*z_max + 6 m of the camera, and the deep classes (ground beyond z_min)
# none nearer than z_min - 6 m, apart from the 4 forced window endpoints.
NEAR_THR2 = (14.6 * 14.6, 20.0 * 20.0, 47.0 * 47.0)
LOWER_THR2 = ((11.6 - 6.0) ** 2, (34.9 - 6.0) ** 2)
# far_decimate: beyond 40 m every other route row is biased out of the
# argmin (window endpoint exempt), so the deep classes need fewer rows. Not
# output-exact: a pixel whose winner was dropped takes the 2 m neighbour's
# line, a few horizon pixels at most.
FAR_DECIMATE_R2 = 40.0 * 40.0


def _camera_basis(ego_pos, ego_yaw):
    fwd = torch.stack([torch.cos(ego_yaw), torch.sin(ego_yaw)], -1)  # [B, 2]
    right = torch.stack([-fwd[:, 1], fwd[:, 0]], -1)  # the vehicle's right in the y-south frame
    cam = ego_pos + CAM_FWD * fwd
    return cam, fwd, right


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _div(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x rounded once, as JAX divides (torch computes a Python scalar
    over a tensor as a reciprocal times c)."""
    return torch.full_like(x, c) / x


def _project(cam, fwd, right, pts, z_world):
    """World xy [B, ..., 2] + height -> pixel (u, v, depth)."""
    shape = (cam.shape[0],) + (1,) * (pts.dim() - 2) + (2,)
    rel = pts - cam.reshape(shape)
    depth = _dot(rel, fwd.reshape(shape))
    lat = _dot(rel, right.reshape(shape))
    safe = depth.clamp_min(0.3)
    u = CX + FX * lat / safe
    num = FX * (CAM_Z - z_world)
    v = CY + (num / safe if isinstance(num, torch.Tensor) else _div(num, safe))
    return u, v, depth


def _actor_boxes(cam, fwd, right, pos, yaw, half_extent, alive, height):
    """Screen-space AABB + depth per actor (painter boxes); pools [B, N]."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    dx = torch.stack([c, s], -1) * half_extent[..., :1]
    dy = torch.stack([-s, c], -1) * half_extent[..., 1:]
    corners = torch.stack([pos + dx + dy, pos + dx - dy, pos - dx + dy, pos - dx - dy], -2)  # [B,N,4,2]
    u, v_bot, depth = _project(cam, fwd, right, corners, 0.0)
    _, v_top, _ = _project(cam, fwd, right, corners, height[..., None])
    visible = alive & (depth.amax(-1) > 0.5) & (depth.amin(-1) < MAX_DEPTH)
    return (u.amin(-1), u.amax(-1), v_top.amin(-1), v_bot.amax(-1),
            torch.where(visible, depth.clamp_min(0.3).mean(-1), float("inf")), visible)


def _collect_actor_boxes(state, cam, fwd, right):
    """All pools -> screen AABB rows [B, A, 8]: u0 u1 v0 v1 depth color ok pad."""
    veh, st, wk = state.vehicles, state.statics, state.walkers
    bike = veh.kind == 1
    pools = [
        _actor_boxes(cam, fwd, right, veh.pos, veh.yaw, veh.half_extent, veh.alive,
                     torch.where(bike, 1.7, 1.5)) + (torch.where(bike, COL_BIKE, COL_CAR),),
        _actor_boxes(cam, fwd, right, st.pos, st.yaw, st.half_extent, st.alive,
                     torch.full_like(st.yaw, 1.4)) + (torch.full_like(st.yaw, COL_STATIC),),
    ]
    wz = torch.zeros_like(wk.ttl)
    pools.append(
        _actor_boxes(cam, fwd, right, wk.pos, wz, torch.full_like(wk.pos, 0.35), wk.alive,
                     wz + 1.8) + (wz + COL_WALKER,))
    u0, u1, v0, v1, depth, vis, color = [torch.cat([p[k] for p in pools], 1) for k in range(7)]
    return torch.stack([u0, u1, v0, v1, torch.where(vis, depth, 1e30), color,
                        vis.float(), torch.zeros_like(u0)], -1)


def _interp(x, xp, fp):
    """jnp.interp per world: x [B], xp and fp [B, K] -> [B], constant
    outside the keyframes and the left value across a zero-width segment
    (padded keyframes repeat the last one), as jnp.interp computes it."""
    k = xp.shape[1]
    i = torch.searchsorted(xp, x[:, None], right=True).clamp(1, k - 1)
    x0, x1 = torch.gather(xp, 1, i - 1)[:, 0], torch.gather(xp, 1, i)[:, 0]
    f0, f1 = torch.gather(fp, 1, i - 1)[:, 0], torch.gather(fp, 1, i)[:, 0]
    dx = x1 - x0
    dx0 = dx.abs() <= _INTERP_EPS
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[:, 0], fp[:, 0], f)
    return torch.where(x > xp[:, -1], fp[:, -1], f)


def weather_now(spec, state) -> torch.Tensor:
    """[B, 5] interpolated (cloud01, precip01, fog01, sun_bright, wet01) at
    the ego's route percentage (RouteWeatherBehavior keyframes)."""
    pct = 100.0 * state.ego.route_idx.float() / spec.route_len.clamp_min(1.0)
    keys = spec.weather_keys  # [B, K, 6] pct, cloud, precip, fog, sun, wet
    xp = keys[..., 0].contiguous()
    cloud, precip, fog, sun, wet = [_interp(pct, xp, keys[..., c]) for c in range(1, 6)]
    bright = 0.35 + 0.65 * ((sun + 10.0) / 70.0).clamp(0.0, 1.0)
    return torch.stack([cloud / 100.0, precip / 100.0, fog / 100.0, bright, wet / 100.0], -1)


def _signal_boxes(spec, state, cam, fwd, right) -> torch.Tensor:
    """Traffic lights (a pole plus a 3-lamp head whose active lamp is
    bright) and stop signs as screen boxes [B, 4*K + K_stop, 8]."""
    t_s = state.t.float() * C.DT

    def head_boxes(s_arr, n_active, half_w, z_lo, z_hi, color, depth_bias=0.0):
        k = s_arr.shape[1]
        active = torch.arange(k, device=s_arr.device)[None] < n_active[:, None]
        idx = s_arr.to(torch.int32).clamp(0, spec.route_xy.shape[1] - 1).long()
        p = torch.gather(spec.route_xy, 1, idx[..., None].expand(-1, -1, 2))
        d = torch.gather(spec.route_dir, 1, idx[..., None].expand(-1, -1, 2))
        rightn = torch.stack([-d[..., 1], d[..., 0]], -1)  # the vehicle's right roadside
        base = p + rightn * (0.5 * C.LANE_WIDTH + 0.6)
        rel = base - cam[:, None]
        depth = _dot(rel, fwd[:, None])
        lat = _dot(rel, right[:, None])
        safe = depth.clamp_min(0.3)
        u_c = CX + FX * lat / safe
        du = _div(FX * half_w, safe)
        v0 = CY + _div(FX * (CAM_Z - z_hi), safe)
        v1 = CY + _div(FX * (CAM_Z - z_lo), safe)
        vis = active & (depth > 0.5) & (depth < MAX_DEPTH)
        # lamps ride slightly in front of the pole so the min-depth
        # composite shows them
        depth = (depth + depth_bias).clamp_min(0.31)
        return torch.stack([u_c - du, u_c + du, v0, v1, torch.where(vis, depth, 1e30),
                            color, vis.float(), torch.zeros_like(depth)], -1)

    color_state = light_state(t_s, spec.tl_offset, spec.tl_green_s, spec.tl_yellow_s,
                              spec.tl_red_s)
    rows = [head_boxes(spec.tl_stop_s, spec.n_tl, 0.12, 0.0, 3.4,
                       torch.full_like(spec.tl_stop_s, COL_POLE))]
    for seg_state, z in ((RED, 3.1), (YELLOW, 2.7), (GREEN, 2.3)):
        col = torch.where(color_state == seg_state, COL_LAMP_ON, COL_LAMP_OFF)
        rows.append(head_boxes(spec.tl_stop_s, spec.n_tl, 0.30, z - 0.2, z + 0.2, col,
                               depth_bias=-0.15))
    rows.append(head_boxes(spec.stop_s, spec.n_stop, 0.40, 1.7, 2.4,
                           torch.full_like(spec.stop_s, COL_STOP_SIGN)))
    return torch.cat(rows, 1)


def _compact_boxes(boxes):
    """Keep the K_BOX nearest on-screen valid boxes [B, K_BOX, 8].

    Min-depth compositing is order-independent, so dropping occluded boxes
    past K is lossless until more than K_BOX boxes overlap the frustum. The
    stable argsort puts the lower index first on equal keys, as
    ``lax.top_k(-key)`` does.
    """
    onscreen = ((boxes[..., 1] >= 0) & (boxes[..., 0] <= W - 1)
                & (boxes[..., 3] >= 0) & (boxes[..., 2] <= H - 1))
    ok = (boxes[..., 6] > 0.5) & onscreen
    key = torch.where(ok, boxes[..., 4], float("inf"))
    k = min(K_BOX, boxes.shape[1])
    order = torch.argsort(key, dim=1, stable=True)[:, :k]
    out = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 8))
    valid = (out[..., 4] < 1e29) & (out[..., 6] > 0.5)
    return torch.cat([out[..., :6], valid.float()[..., None], out[..., 7:]], -1)


def _pallas_inputs(spec, state, cam, fwd, right, boxes, weather, far_decimate: bool = False):
    """Assemble the render operands per world.

    Returns cam_scalars [B, 18], cols [B, 160, 8] and compacted boxes
    [B, 32, 8]. The terrain argmin compares t = -2 g.q + |q|^2 (|g|^2
    dropped) over the route window and the scenario-flow points, so each
    row carries c1=-2qx, c2=-2qy, c3=|q|^2 (+1e12 when invalid), its
    direction (dx, dy), e3 = dx*qy - dy*qx for the post-loop lateral
    solve, its original index j (j < 128: route, else flow) and the road
    corridor's upper bound. Coordinates are CAMERA-RELATIVE: world-absolute
    magnitudes (~1e3) would cancel the ~m^2 argmin contrasts out of f32.
    Rows are distance-sorted with the window endpoints forced to the front,
    exactly as the JAX package orders them. ``far_decimate`` biases every
    other far route row out (FAR_DECIMATE_R2).
    """
    b = cam.shape[0]
    dev = cam.device
    lw = C.LANE_WIDTH
    m = spec.route_xy.shape[1]
    start = (state.ego.route_idx - ROUTE_BEHIND).clamp(0, m - ROUTE_VIEW)
    ar = torch.arange(ROUTE_VIEW, device=dev)
    ridx = (start[:, None] + ar[None]).long()
    q = torch.gather(spec.route_xy, 1, ridx[..., None].expand(-1, -1, 2)) - cam[:, None]
    qd = torch.gather(spec.route_dir, 1, ridx[..., None].expand(-1, -1, 2))
    valid = (ridx < spec.n_route[:, None]).float()
    c3 = (q * q).sum(-1) + (1.0 - valid) * 1e12
    n_valid_route = (spec.n_route - start).clamp(1, ROUTE_VIEW).long()
    if far_decimate:
        # the window endpoints keep their forced front rank: they stay winnable
        drop = ((ar % 2 == 1) & ((q * q).sum(-1) > FAR_DECIMATE_R2)
                & (ar != (n_valid_route - 1)[:, None]))
        c3 = c3 + drop.float() * 1e12
    e3 = qd[..., 0] * q[..., 1] - qd[..., 1] * q[..., 0]
    route_cols = torch.stack(
        [-2.0 * q[..., 0], -2.0 * q[..., 1], c3, qd[..., 0], qd[..., 1], e3,
         ar.float().expand(b, -1), torch.full_like(c3, 1.5 * lw + 0.3)], -1)
    # scenario flow polyline (slot 0: the explicit/crossing flow); slot 1
    # rides the ego's own road and is already inside the route corridor
    fsel = torch.arange(FLOW_VIEW, device=dev) * FLOW_STRIDE
    fq = spec.flow_xy[:, 0, fsel] - cam[:, None]
    fqd = spec.flow_dir[:, 0, fsel]
    fvalid = (fsel.float()[None] <= spec.flow_len[:, :1]) & spec.flow_enabled[:, :1]
    fc3 = (fq * fq).sum(-1) + torch.where(fvalid, 0.0, 1e12)
    fe3 = fqd[..., 0] * fq[..., 1] - fqd[..., 1] * fq[..., 0]
    flow_cols = torch.stack(
        [-2.0 * fq[..., 0], -2.0 * fq[..., 1], fc3, fqd[..., 0], fqd[..., 1], fe3,
         (ROUTE_VIEW + torch.arange(FLOW_VIEW, device=dev)).float().expand(b, -1),
         torch.full_like(fc3, 0.5 * lw + 0.3)], -1)
    cols = torch.cat([route_cols, flow_cols], 1)

    # sort key: camera distance, window endpoints forced to the front (the
    # sets below run in the JAX package's order, later ones winning)
    key = cols[..., 2].clone()
    lastf = (fvalid.sum(-1) - 1).clamp_min(0)
    any_f = fvalid.any(-1)
    key[:, 0] = -0.7
    key.scatter_(1, (n_valid_route - 1)[:, None], -1.0)
    key[:, ROUTE_VIEW] = torch.where(any_f, -0.6, key[:, ROUTE_VIEW])
    li = (ROUTE_VIEW + lastf)[:, None]
    key.scatter_(1, li, torch.where(any_f[:, None], -0.5, torch.gather(key, 1, li)))
    order = torch.argsort(key, dim=1, stable=True)
    cols = torch.gather(cols, 1, order[..., None].expand(-1, -1, 8))
    counts = [(key < t).sum(-1) for t in NEAR_THR2] + [(key < 1e11).sum(-1)]
    counts_lower = [(key < t).sum(-1) for t in LOWER_THR2]

    cboxes = _compact_boxes(boxes)
    cam_scalars = torch.stack(
        [fwd[:, 0], fwd[:, 1], right[:, 0], right[:, 1], weather[:, 0], start.float(),
         weather[:, 1], weather[:, 2], weather[:, 3], weather[:, 4],
         spec.flow_enabled[:, 0].float(),  # diagnostic only
         *[c.float() for c in counts],  # slots 11-14
         cboxes[..., 6].sum(-1),  # slot 15: visible boxes
         *[c.float() for c in counts_lower]], -1)  # slots 16-17
    return cam_scalars, cols, cboxes


def render_frame(spec, state, *, far_decimate: bool = False,
                 lower_window: bool = False) -> torch.Tensor:
    """Grayscale frames [B, H, W] in [0, 1] from each ego camera, on the
    device the state lives on: the CUDA kernel for CUDA tensors (it launches
    or raises), its plain PyTorch version for CPU tensors. The two flags are
    the TPU kernel's variants (GABRIL_FAR_DECIMATE and GABRIL_LOWER_WINDOW
    in the JAX package); the defaults are its default path."""
    cam, fwd, right = _camera_basis(state.ego.pos, state.ego.yaw)
    boxes = torch.cat([_collect_actor_boxes(state, cam, fwd, right),
                       _signal_boxes(spec, state, cam, fwd, right)], 1)
    weather = weather_now(spec, state)
    cam_scalars, cols, cboxes = _pallas_inputs(spec, state, cam, fwd, right, boxes, weather,
                                               far_decimate=far_decimate)
    return render_from_operands(cam_scalars, cols, cboxes, far_decimate=far_decimate,
                                lower_window=lower_window)


AHEAD_WIN = 80  # route rows ahead of the ego the actors are placed on


def analytic_gaze(spec, state, max_points: int = 5,
                  curvature_anticipation: bool = False) -> torch.Tensor:
    """Gaze coords [B, max_points * 2] in [0, 1] (-1 invalid) from the scene
    graph, for every world at once (the JAX package's is per world, and its
    docstring gives the reasons).

    Point 0 fixates the road about 15 m ahead along the route, or with
    ``curvature_anticipation`` the tangent point of the coming curve at a
    speed-scaled preview distance; the other slots take the visible actors
    of highest hazard (actor_hazards), ties in index order as the stable
    ``jnp.argsort`` keeps them.
    """
    from ..env.dynamics import polyline_point

    ego = state.ego
    cam, fwd, right = _camera_basis(ego.pos, ego.yaw)
    s_now = ego.route_idx.float()
    if curvature_anticipation:
        # preview distance: time headway, clamped (8 m crawl .. 25 m fast)
        look = (1.7 * ego.speed.clamp_min(2.0)).clamp(8.0, 25.0)
        _, d_now = polyline_point(spec.route_xy, spec.route_dir, s_now, spec.n_route)
        _, d_prev = polyline_point(spec.route_xy, spec.route_dir, s_now + look, spec.n_route)
        # sin(heading change) over the preview; positive is a right turn
        turn = d_now[:, 0] * d_prev[:, 1] - d_now[:, 1] * d_prev[:, 0]
        look_eff = look / (1.0 + 2.0 * turn.abs())
        p_fix, d_fix = polyline_point(spec.route_xy, spec.route_dir, s_now + look_eff,
                                      spec.n_route)
        inside = torch.stack([-d_fix[:, 1], d_fix[:, 0]], -1)  # the driver's right normal
        ahead = p_fix + (turn.clamp(-1.0, 1.0) * (0.5 * C.LANE_WIDTH))[:, None] * inside
    else:
        ahead, _ = polyline_point(spec.route_xy, spec.route_dir, s_now + 15.0, spec.n_route)
    ur, vr, dr = (x[:, 0] for x in _project(cam, fwd, right, ahead[:, None], 0.0))
    road_ok = (dr > 1.0) & (ur >= 0) & (ur < W) & (vr >= 0) & (vr < H)
    road_pt = torch.where(road_ok[:, None], torch.stack([ur / (W - 1), vr / (H - 1)], -1), -1.0)

    u, v, score = actor_hazards(spec, state, cam, fwd, right)
    order = torch.argsort(-score, dim=1, stable=True)[:, :max_points - 1]
    sel_valid = torch.isfinite(torch.gather(score, 1, order))
    gx = torch.where(sel_valid, torch.gather(u, 1, order) / (W - 1), -1.0)
    gy = torch.where(sel_valid, torch.gather(v, 1, order) / (H - 1), -1.0)
    actors = torch.stack([gx, gy], -1)
    return torch.cat([road_pt[:, None], actors], 1).reshape(-1, max_points * 2)


def actor_hazards(spec, state, cam, fwd, right):
    """Every actor's pixel (u, v) and hazard score [B, N] (-inf where not
    visible): vehicles, walkers, then statics. In-path actors score by the
    ego's time to reach them, actors closing on the route by how well their
    crossing time aligns with the ego's arrival, all with a proximity
    floor."""
    from ..env.dynamics import take_rows

    ego = state.ego
    veh, wk, st = state.vehicles, state.walkers, state.statics
    pos = torch.cat([veh.pos, wk.pos, st.pos], 1)  # [B, N, 2]
    alive = torch.cat([veh.alive, wk.alive, st.alive], 1)
    vhead = torch.stack([torch.cos(veh.yaw), torch.sin(veh.yaw)], -1)
    vel = torch.cat([veh.speed[..., None] * vhead, wk.vel, torch.zeros_like(st.pos)], 1)
    z = torch.cat([torch.full_like(veh.yaw, 0.9), torch.full_like(wk.pos[..., 0], 1.0),
                   torch.full_like(st.yaw, 0.8)], 1)
    u, v, depth = _project(cam, fwd, right, pos, z)
    visible = alive & (depth > 1.0) & (depth < 80.0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    # relevance to the ego's plan: each actor placed on the route window ahead
    start = ego.route_idx.clamp(0, spec.route_xy.shape[1] - AHEAD_WIN)
    widx = start[:, None] + torch.arange(AHEAD_WIN, device=start.device)[None]
    win = take_rows(spec.route_xy, widx)  # [B, 80, 2]
    wdir = take_rows(spec.route_dir, widx)
    diff = pos[:, :, None, :] - win[:, None, :, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]  # [B, N, 80]
    j = torch.argmin(d2, -1)  # the first of tied minima, as jnp.argmin
    nd = take_rows(wdir, j)
    relr = pos - take_rows(win, j)
    s_a = (start[:, None] + j).float()
    s_ego = ego.route_idx.float()[:, None]
    lat = -(nd[..., 0] * relr[..., 1] - nd[..., 1] * relr[..., 0])  # +left of route
    near_route = torch.sqrt(d2.amin(-1)) < 40.0
    ahead_ok = near_route & (s_a > s_ego - 2.0) & (s_a < s_ego + 70.0)
    t_ego = (s_a - s_ego) / ego.speed.clamp_min(2.0)[:, None]
    in_path = ahead_ok & (lat.abs() < 2.2)
    # lateral closing speed toward the centerline
    dlat_dt = nd[..., 1] * vel[..., 0] - nd[..., 0] * vel[..., 1]
    v_toward = -torch.sign(lat) * dlat_dt
    t_cross = ((lat.abs() - 1.0) / v_toward.clamp_min(0.15)).clamp_min(0.0)
    crossing = ahead_ok & (v_toward > 0.4)
    rel = pos - ego.pos[:, None]
    dist = torch.sqrt(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]).clamp_min(1.0)
    hazard = (_div(0.3, dist)
              + torch.where(in_path, _div(2.0, t_ego.clamp_min(0.5)), 0.0)
              + torch.where(crossing, _div(2.0, t_cross.clamp_min(0.2) + (t_ego - t_cross).abs()),
                            0.0))
    return u, v, torch.where(visible, hazard, float("-inf"))


def confounded_overlay(img: torch.Tensor, action7: torch.Tensor) -> torch.Tensor:
    """Bake action indicators into frames [B, H, W] from actions [B, 7]
    (saliency_pipeline build_confunded_obs.py semantics: a brake dot and a
    steering bar)."""
    h, w = img.shape[-2], img.shape[-1]
    vv = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    uu = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    brake = (action7[..., 2] > 0.8)[:, None, None]
    dot = ((uu - 0.92 * w) ** 2 + (vv - 0.85 * h) ** 2) < (0.03 * w) ** 2
    img = torch.where(dot & brake, 1.0, img)
    steer = action7[..., 1].clamp(-1.0, 1.0)
    bar_y = (vv - 0.92 * h).abs() < 0.015 * h
    cxp = (0.5 * w + steer * 0.2 * w)[:, None, None]
    bar_x = (uu > torch.clamp(cxp, max=0.5 * w)) & (uu < torch.clamp(cxp, min=0.5 * w))
    return torch.where(bar_y & bar_x, 0.95, img)
