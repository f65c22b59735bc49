"""Route criteria + driving score as per-step reductions, batched over worlds.

Port of gabril_carla_tpu/env/criteria.py (srunner atomic_criteria and the
leaderboard statistics_manager parity targets are listed there):
RouteCompletionTest, CollisionTest with its dedup rules,
OutsideRouteLanesTest, ActorBlockedTest, InRouteTest, RunningRedLightTest,
RunningStopTest, MinimumSpeedRouteTest, ScenarioTimeoutTest, and
score_composed = max(route_completion% * product(penalties), 0).
"""

from __future__ import annotations

import torch

from . import constants as C
from .ambient import ambient_speeds
from .state import SceneState, in_any_window, pair, take
from .traffic_lights import red_light_crossing

ROUTE_WINDOW = 20  # forward search window for ego localization (1 m points)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def localize_ego(spec, pos: torch.Tensor, route_idx: torch.Tensor):
    """Monotonic route tracker: nearest point in a forward window.
    Returns (new_idx int32 [B], distance to it [B])."""
    start = route_idx.clamp(0, spec.route_xy.shape[1] - ROUTE_WINDOW)
    win_idx = start[:, None] + torch.arange(ROUTE_WINDOW, device=pos.device)[None]
    win = torch.gather(spec.route_xy, 1, win_idx.long()[..., None].expand(-1, -1, 2))
    d = _norm(win - pos[:, None, :])
    off = d.argmin(-1)  # first minimum, as jnp.argmin
    new_idx = torch.minimum(start + off, spec.n_route - 1)
    return new_idx.to(torch.int32), take(d, off)


def _obb_overlap(pos_a, yaw_a, ext_a, pos_b, yaw_b, ext_b):
    """2D OBB overlap via the separating-axis test (4 axes). The ego's box
    (pos_a [B, 2], yaw_a [B], ext_a [B, 1, 2]) against a pool's boxes (pos_b
    [B, N, 2], yaw_b [B, N], ext_b [B, N, 2]); returns [B, N] bool."""
    shape = yaw_b.shape
    yaw_a = yaw_a[:, None].expand(shape)
    pos_a = pos_a[:, None, :].expand(shape + (2,))
    ext_a = ext_a.expand(shape + (2,))

    def axes(yaw):
        c, s = torch.cos(yaw), torch.sin(yaw)
        return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)  # [..., 2, 2]

    ax_a, ax_b = axes(yaw_a), axes(yaw_b)
    allax = torch.cat([ax_a, ax_b], -2)  # [..., 4, 2]
    delta = pos_b - pos_a

    def project(ext, ax_own):
        # half-projection of a box with half-extents ext onto each axis
        dots = (ax_own[..., None, :, :] * allax[..., :, None, :]).sum(-1)  # [..., 4, 2]
        return (ext[..., None, :] * dots.abs()).sum(-1)

    ra = project(ext_a, ax_a)
    rb = project(ext_b, ax_b)
    dist = (delta[..., None, :] * allax).sum(-1).abs()
    return (dist <= ra + rb).all(-1)


def criteria_step(spec, state: SceneState) -> SceneState:
    crit = state.criteria
    ego = state.ego
    dev = ego.pos.device
    new_idx, lat = localize_ego(spec, ego.pos, ego.route_idx)
    step_m = ego.speed * C.DT

    # --- OutsideRouteLanesTest: off the road edge, or in the oncoming lane
    # outside a lane-allow window, both forgiven on junction pavement
    s_here = new_idx.float()
    in_allow = in_any_window(s_here, spec.lane_allow)
    tang = take(spec.route_dir, new_idx)
    delta_r = ego.pos - take(spec.route_xy, new_idx)
    signed_lat = delta_r[:, 0] * tang[:, 1] - delta_r[:, 1] * tang[:, 0]
    fd2 = ((spec.flow_xy - ego.pos[:, None, None, :]) ** 2).sum(-1)  # [B, N_FLOWS, F]
    fmin = fd2.argmin(-1)  # [B, N_FLOWS]
    fdist = torch.sqrt(torch.gather(fd2, 2, fmin[..., None])[..., 0])
    fdir = torch.gather(spec.flow_dir, 2, fmin[..., None, None].expand(-1, -1, 1, 2))[:, :, 0]
    is_crossing = (fdir * tang[:, None, :]).sum(-1).abs() < 0.7
    on_junction = (spec.flow_enabled & is_crossing
                   & (fdist <= 0.5 * C.LANE_WIDTH + C.ALLOWED_OUT_DISTANCE)).any(-1)
    wrong_lane = (signed_lat > 0.5 * C.LANE_WIDTH) & ~in_allow & ~on_junction
    off_road = ((signed_lat < -(0.5 * C.LANE_WIDTH + C.ALLOWED_OUT_DISTANCE))
                | (signed_lat > 1.5 * C.LANE_WIDTH + C.ALLOWED_OUT_DISTANCE)) & ~on_junction
    outside = wrong_lane | off_road
    outside_m = crit.outside_lane_m + torch.where(outside, step_m, 0.0)

    # --- collisions (ego OBB vs pools; walkers as body circles)
    ego_ext = pair(ego.speed, C.EGO_HALF_LEN, C.EGO_HALF_WID)[:, None, :]
    veh = state.vehicles
    hit_v = _obb_overlap(ego.pos, ego.yaw, ego_ext, veh.pos, veh.yaw, veh.half_extent) & veh.alive
    st = state.statics
    hit_s = _obb_overlap(ego.pos, ego.yaw, ego_ext, st.pos, st.yaw, st.half_extent) & st.alive
    wk = state.walkers
    rel = wk.pos - ego.pos[:, None, :]
    cy, sy = torch.cos(ego.yaw)[:, None], torch.sin(ego.yaw)[:, None]
    lx = rel[..., 0] * cy + rel[..., 1] * sy  # longitudinal in ego frame
    ly = -rel[..., 0] * sy + rel[..., 1] * cy
    gap_x = (lx.abs() - C.EGO_HALF_LEN).clamp_min(0.0)
    gap_y = (ly.abs() - C.EGO_HALF_WID).clamp_min(0.0)
    hit_w = (gap_x ** 2 + gap_y ** 2 < C.WALKER_RADIUS ** 2) & wk.alive

    # dedup: same actor within MAX_ID_TIME counts once; any event within
    # COLLISION_RADIUS of the last one counts once; a ~stationary ego is not
    # at fault. Identity = (pool-offset slot id, spawn generation).
    t_now = state.t.float() * C.DT
    nv, nw = hit_v.shape[1], hit_w.shape[1]
    id_active = (crit.last_collision_id >= 0) & (
        t_now - crit.last_collision_time <= C.COLLISION_MAX_ID_TIME)
    loc_valid = crit.collision_loc_valid & (
        _norm(ego.pos - crit.last_collision_pos) <= C.COLLISION_RADIUS)
    blocked_all = loc_valid | (ego.speed < C.COLLISION_EPSILON)
    ar_v = torch.arange(nv, device=dev, dtype=torch.int32)[None]
    ar_w = nv + torch.arange(nw, device=dev, dtype=torch.int32)[None]
    ar_s = nv + nw + torch.arange(hit_s.shape[1], device=dev, dtype=torch.int32)[None]
    last_id = crit.last_collision_id[:, None]
    gen0 = (crit.last_collision_gen == 0)[:, None]
    elig_v = hit_v & ~(id_active[:, None] & (ar_v == last_id)
                       & (veh.gen == crit.last_collision_gen[:, None]))
    elig_w = hit_w & ~(id_active[:, None] & (ar_w == last_id) & gen0)
    elig_s = hit_s & ~(id_active[:, None] & (ar_s == last_id) & gen0)
    any_v = elig_v.any(-1) & ~blocked_all
    any_w = elig_w.any(-1) & ~blocked_all & ~any_v
    any_s = elig_s.any(-1) & ~blocked_all & ~any_v & ~any_w
    fired = any_v | any_w | any_s
    first_v = elig_v.to(torch.uint8).argmax(-1)
    event_id = torch.where(
        any_v, first_v,
        torch.where(any_w, nv + elig_w.to(torch.uint8).argmax(-1),
                    nv + nw + elig_s.to(torch.uint8).argmax(-1))).to(torch.int32)
    event_gen = torch.where(any_v, take(veh.gen, first_v), 0).to(torch.int32)
    new_id = torch.where(fired, event_id, crit.last_collision_id)
    new_gen = torch.where(fired, event_gen, crit.last_collision_gen)
    new_time = torch.where(fired, t_now, crit.last_collision_time)
    new_last = torch.where(fired[:, None], ego.pos, crit.last_collision_pos)
    new_loc_valid = fired | loc_valid

    # --- blocked
    blocked_time = torch.where(ego.speed < C.BLOCKED_SPEED, crit.blocked_time + C.DT, 0.0)
    blocked = crit.blocked | (blocked_time >= C.BLOCKED_SECONDS)

    # --- red light
    ran_red = red_light_crossing(
        spec.tl_stop_s, spec.tl_offset, spec.n_tl, ego.route_idx, new_idx, t_now,
        spec.tl_green_s, spec.tl_yellow_s, spec.tl_red_s)

    # --- route deviation
    deviated = crit.deviated | (lat > C.IN_ROUTE_RADIUS)

    # --- stop signs: one full stop inside [stop_s-4, stop_s+5] per sign;
    # leaving the zone without it counts one infraction, once
    s_ego = s_here[:, None]
    sign_on = torch.arange(spec.stop_s.shape[1], device=dev)[None] < spec.n_stop[:, None]
    in_zone = sign_on & (s_ego >= spec.stop_s - 4.0) & (s_ego <= spec.stop_s + 5.0)
    stopped_now = (ego.speed < C.BLOCKED_SPEED)[:, None]
    stop_done = crit.stop_done | (in_zone & stopped_now)
    pending = (in_zone & ~stop_done).any(-1)
    left_zone = sign_on & (s_ego > spec.stop_s + 5.0) & ~stop_done
    stop_inf = crit.stop_infraction + left_zone.to(torch.int32).sum(-1, dtype=torch.int32)
    stop_done = stop_done | left_zone

    # --- min speed vs ambient traffic, folded per route-quarter checkpoint
    amb_mean, has_amb = ambient_speeds(state.vehicles, spec)
    ego_sum = crit.ms_ego_sum + torch.where(has_amb, ego.speed, 0.0)
    amb_sum = crit.ms_amb_sum + torch.where(has_amb, amb_mean, 0.0)
    ticks = crit.ms_ticks + has_amb.float()
    cur_ck = (4.0 * s_here / spec.route_len.clamp_min(1.0)).to(torch.int32).clamp(0, 3)
    fold = cur_ck > crit.ms_ckpt
    ck_value = torch.where(ticks > 0, 100.0 * ego_sum / amb_sum.clamp_min(1e-6), 100.0)
    ck_factor = torch.where(ck_value < 100.0,
                            1.0 - (1.0 - C.PENALTY_MIN_SPEED) * (1.0 - ck_value / 100.0), 1.0)
    ms_penalty = torch.where(fold, crit.ms_penalty * ck_factor, crit.ms_penalty)
    ego_sum = torch.where(fold, 0.0, ego_sum)
    amb_sum = torch.where(fold, 0.0, amb_sum)
    ticks = torch.where(fold, 0.0, ticks)

    crit = crit.replace(
        collisions_vehicle=crit.collisions_vehicle + any_v.to(torch.int32),
        collisions_pedestrian=crit.collisions_pedestrian + any_w.to(torch.int32),
        collisions_static=crit.collisions_static + any_s.to(torch.int32),
        last_collision_id=new_id,
        last_collision_gen=new_gen,
        last_collision_time=new_time,
        last_collision_pos=new_last,
        collision_loc_valid=new_loc_valid,
        outside_lane_m=outside_m,
        driven_m=crit.driven_m + step_m,
        ms_ego_sum=ego_sum, ms_amb_sum=amb_sum, ms_ticks=ticks,
        ms_ckpt=torch.where(fold, cur_ck, crit.ms_ckpt),
        ms_penalty=ms_penalty,
        red_light=crit.red_light + ran_red.to(torch.int32),
        blocked_time=blocked_time,
        blocked=blocked,
        deviated=deviated,
        stop_pending=pending,
        stop_done=stop_done,
        stop_infraction=stop_inf,
    )
    return state.replace(ego=ego.replace(route_idx=new_idx), criteria=crit)


def completion_pct(spec, state: SceneState) -> torch.Tensor:
    """Route completion % with the 99%/10 m goal rule."""
    pct = 100.0 * state.ego.route_idx.float() / spec.route_len.clamp_min(1.0)
    goal = take(spec.route_xy, (spec.n_route - 1).clamp_min(0))
    near_goal = _norm(state.ego.pos - goal) <= C.COMPLETION_DIST
    return torch.where((pct >= C.COMPLETION_PCT) & near_goal, 100.0, pct.clamp_max(100.0))


def compute_score(spec, state: SceneState) -> dict:
    """score_composed = max(route% * product(penalties), 0) per world
    (statistics_manager.py:349-416)."""
    crit = state.criteria
    pct = completion_pct(spec, state)
    ev_failed = ((spec.scenario_type == 11) & (state.scenario.aux > 8.0)).any(-1)

    def pw(base, n):
        return torch.pow(torch.full_like(pct, base), n.float())

    penalty = (
        pw(C.PENALTY_COLLISION_PEDESTRIAN, crit.collisions_pedestrian)
        * pw(C.PENALTY_COLLISION_VEHICLE, crit.collisions_vehicle)
        * pw(C.PENALTY_COLLISION_STATIC, crit.collisions_static)
        * pw(C.PENALTY_RED_LIGHT, crit.red_light)
        * pw(C.PENALTY_STOP_SIGN, crit.stop_infraction)
        # one 0.7x per timed-out scenario slot
        * torch.where(state.scenario.timed_out, C.PENALTY_SCENARIO_TIMEOUT, 1.0).prod(-1)
        * torch.where(ev_failed, C.PENALTY_YIELD_EMERGENCY, 1.0)
    )
    pct_outside = 100.0 * crit.outside_lane_m / crit.driven_m.clamp_min(1e-3)
    penalty = penalty * (1.0 - pct_outside.clamp(0.0, 100.0) / 100.0)
    # the last open min-speed checkpoint folds here past 95 % of the route
    final_value = torch.where(crit.ms_ticks > 0,
                              100.0 * crit.ms_ego_sum / crit.ms_amb_sum.clamp_min(1e-6), 100.0)
    final_factor = torch.where(
        (pct > 95.0) & (final_value < 100.0),
        1.0 - (1.0 - C.PENALTY_MIN_SPEED) * (1.0 - final_value / 100.0), 1.0)
    penalty = penalty * crit.ms_penalty * final_factor
    score = (pct * penalty).clamp_min(0.0)
    return {
        "score_route": pct,
        "score_penalty": penalty,
        "score_composed": score,
        "collisions_vehicle": crit.collisions_vehicle,
        "collisions_pedestrian": crit.collisions_pedestrian,
        "collisions_static": crit.collisions_static,
        "red_light": crit.red_light,
        "stop_infraction": crit.stop_infraction,
        "outside_route_lanes_pct": pct_outside,
        "min_speed_penalty": crit.ms_penalty * final_factor,
        "scenario_timeout": state.scenario.timed_out.to(torch.int32).sum(-1, dtype=torch.int32),
        "yield_emergency": ev_failed,
        "blocked": crit.blocked,
        "deviated": crit.deviated,
    }
