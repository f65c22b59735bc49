"""Privileged scripted expert: pure pursuit + hazard yielding + overtaking
(port of gabril_carla_tpu/env/expert.py).

The JAX expert is written for one world and vmapped by its callers; this one
takes every world at once: ``expert_action(spec, state) -> [B, 7]``. It is a
stateless function of (WorldSpec, SceneState): overtake decisions come from
the scene geometry every tick. It handles the benchmark's scenario families:
corridor braking, crossing-flow yield, walker yield, stop signs, traffic
lights and opposite-lane overtakes around static obstructions. The JAX
module's comments give the reason for each threshold.

Every decision is a threshold, so the argmins and argmaxes keep the first
index on ties (torch's do, as jnp's do) and the reductions over padded
actors use +-inf as the JAX ones.
"""

from __future__ import annotations

import torch

from . import constants as C
from .dynamics import _MAX_STEER_RAD, left_normal, polyline_point, take_rows
from .state import SceneState, in_any_window, take
from .traffic_lights import GREEN, light_state

CRUISE_SPEED = 9.0  # m/s, above the 7.0 ambient cruise
HAZARD_AHEAD = 11.0  # shorter than BlockedIntersection's 13 m trigger
HAZARD_HALF_WIDTH = 1.5
ROUTE_WIN = 48  # forward window for obstacle route-projection (1 m points)

# scenario type codes (env/world.py: SCENARIO_TYPES)
_PARKING_EXIT, _TWOWAYS, _CROSSING_FLOW, _EMERGENCY = 0, (2, 5, 9), 4, 11


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _route_window(spec, ego_idx: torch.Tensor):
    """(start [B], window rows [B, ROUTE_WIN]) of the route points from 8
    behind the ego, the start clipped so that the window fits (the JAX
    package's dynamic_slice with a clipped start)."""
    start = (ego_idx.long() - 8).clamp(0, spec.route_xy.shape[1] - ROUTE_WIN)
    rows = start[:, None] + torch.arange(ROUTE_WIN, device=start.device)[None]
    return start, rows


def _route_frame(spec, pts: torch.Tensor, ego_idx: torch.Tensor):
    """Project points [B, N, 2] onto the route near each ego: (s, signed
    left offset, ok), each [B, N]."""
    start, rows = _route_window(spec, ego_idx)
    win = take_rows(spec.route_xy, rows)  # [B, W, 2]
    wdir = take_rows(spec.route_dir, rows)
    d2 = ((pts[:, :, None, :] - win[:, None, :, :]) ** 2).sum(-1)  # [B, N, W]
    j = torch.argmin(d2, dim=2)
    near, nd = take_rows(win, j), take_rows(wdir, j)
    rel = pts - near
    s = (start[:, None] + j).float()
    lat = -(nd[..., 0] * rel[..., 1] - nd[..., 1] * rel[..., 0])  # +left
    ok = torch.sqrt(d2.amin(2)) < 8.0
    return s, lat, ok


def expert_action(spec, state: SceneState) -> torch.Tensor:
    """[B, 7] controls (autonomous_agent.py codec) from privileged state."""
    ego = state.ego
    s_ego = ego.route_idx.float()  # [B]
    heading = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], -1)  # [B, 2]
    left = left_normal(heading)
    veh, wk, st = state.vehicles, state.walkers, state.statics
    s_col = s_ego[:, None]

    # ---------- obstructions in my lane -> overtake plan
    static_veh = veh.alive & (veh.speed < 0.5) & (veh.target_speed < 0.5)
    obs_pos = torch.cat([veh.pos, st.pos], 1)
    obs_alive = torch.cat([static_veh, st.alive], 1)
    obs_s, obs_lat, obs_ok = _route_frame(spec, obs_pos, ego.route_idx)
    in_my_lane = obs_alive & obs_ok & (obs_lat.abs() < 2.1)
    ahead = in_my_lane & (obs_s > s_col - 4.0) & (obs_s < s_col + 28.0)
    inf = torch.full_like(obs_s, float("inf"))
    blocker_s = torch.where(ahead, obs_s, inf).amin(1)
    blocker_end = torch.where(ahead, obs_s, -inf).amax(1)
    has_blocker = torch.isfinite(blocker_s)
    stype = spec.scenario_type  # [B, K]
    twoways = (stype == _TWOWAYS[0]) | (stype == _TWOWAYS[1]) | (stype == _TWOWAYS[2])
    tw_windows = torch.where(twoways[..., None], spec.lane_allow, 0.0)  # [B, K, 2]
    overtake_scenario = in_any_window(blocker_s, tw_windows)
    in_overtake = (overtake_scenario & has_blocker
                   & (s_ego > blocker_s - 12.0) & (s_ego < blocker_end + 8.0))

    # oncoming traffic in the opposite lane blocks the overtake (~80 m look)
    onc_s, onc_lat, onc_ok = _route_frame(spec, veh.pos, ego.route_idx)
    oncoming = (veh.alive & onc_ok & (veh.speed > 0.5) & (onc_lat > 1.2) & (onc_lat < 5.8)
                & (onc_s > s_col - 4.0) & (onc_s < s_col + 80.0))
    oncoming_busy = oncoming.any(1)
    # committed once already in the opposite lane: finish the pass
    _, ego_lat, _ = _route_frame(spec, ego.pos[:, None], ego.route_idx)
    ego_lat = ego_lat[:, 0]
    committed = ego_lat > 1.2
    do_overtake = in_overtake & (~oncoming_busy | committed)
    wait_for_gap = in_overtake & oncoming_busy & ~committed & (s_ego > blocker_s - 13.0)
    target_offset = torch.where(do_overtake, C.LANE_WIDTH, 0.0)

    # ---------- emergency vehicle behind: pull right and slow until passed.
    # The EV rides its slot's scripted-vehicle base (first EV slot).
    is_ev = stype == _EMERGENCY
    evb = take(spec.scen_veh_base, torch.argmax(is_ev.int(), 1))
    ev_rel = take(veh.pos, evb) - ego.pos
    ev_yield = (is_ev.any(1) & take(veh.alive, evb) & (take(veh.mode, evb) == 2)
                & (_dot(ev_rel, heading) < 3.0) & (torch.sqrt((ev_rel ** 2).sum(-1)) < 32.0))
    target_offset = torch.where(ev_yield, -1.9, target_offset)

    # ---------- pure pursuit toward the offset route point
    lookahead = 2.5 + 0.45 * ego.speed
    tgt, tdir = polyline_point(spec.route_xy, spec.route_dir, s_ego + lookahead, spec.n_route)
    tgt = tgt + target_offset[:, None] * left_normal(tdir)
    rel = tgt - ego.pos
    fwd_dist = _dot(rel, heading).clamp_min(0.5)
    alpha = torch.atan2(_dot(rel, left), fwd_dist)  # >0: target on the driver's left
    delta = torch.atan2(2.0 * C.EGO_WHEELBASE * torch.sin(alpha), lookahead.clamp_min(1.0))
    # positive steer turns toward the driver's right (ego_step convention)
    steer = (-delta / _MAX_STEER_RAD).clamp(-1.0, 1.0)

    # ---------- curvature-aware target speed
    _, d0 = polyline_point(spec.route_xy, spec.route_dir, s_ego + 2.0, spec.n_route)
    _, d1 = polyline_point(spec.route_xy, spec.route_dir, s_ego + 8.0, spec.n_route)
    _, d2 = polyline_point(spec.route_xy, spec.route_dir, s_ego + 16.0, spec.n_route)
    turn = torch.maximum(1.0 - _dot(d1, d2).abs(), 1.0 - _dot(d0, d1).abs())
    v_target = CRUISE_SPEED * (1.0 - (6.0 * turn).clamp(0.0, 0.8))
    v_target = torch.where(do_overtake, v_target.clamp_max(6.0), v_target)
    v_target = torch.where(ev_yield, v_target.clamp_max(2.5), v_target)

    # ---------- corridor braking (center shifted when overtaking)
    def corridor_hit(pos, alive, half_w, length):
        rel = pos - ego.pos[:, None]
        f = _dot(rel, heading[:, None])
        lat = _dot(rel, left[:, None]) - ego.steer[:, None] * 0.0  # along the current heading
        return (alive & (f > 0.0) & (f < length)
                & ((lat - target_offset[:, None] * 0.5).abs() < half_w)).any(1)

    moving_veh = veh.alive & (veh.speed >= 0.5)
    vdir = torch.stack([torch.cos(veh.yaw), torch.sin(veh.yaw)], -1)  # [B, N, 2]
    same_dir = _dot(vdir, heading[:, None]) > 0.7
    # same-direction leader: gap-keeping follower at ~9 m
    relv = veh.pos - ego.pos[:, None]
    fv = _dot(relv, heading[:, None])
    lv = _dot(relv, left[:, None])
    lead = (moving_veh & same_dir & (fv > 0.0) & (fv < 20.0)
            & ((lv - target_offset[:, None] * 0.5).abs() < 2.0))
    lead_i = torch.argmin(torch.where(lead, fv, torch.full_like(fv, float("inf"))), 1)
    has_lead = lead.any(1)
    follow = (take(veh.speed, lead_i) + 0.4 * (take(fv, lead_i) - 9.0)).clamp_min(0.0)
    v_target = torch.where(has_lead, torch.minimum(v_target, follow), v_target)
    close_lead = (lead & (fv < 6.0)).any(1)

    # crossing movers close fast: a longer corridor than for statics, but
    # never for oncoming cars in their own lane (or during a committed pass)
    in_opposite_lane = veh.alive & onc_ok & (onc_lat > 1.2) & (onc_lat < 5.8)
    ego_in_own_lane = ego_lat.abs() < 1.2
    cross_threat = moving_veh & ~same_dir & ~(
        in_opposite_lane & (ego_in_own_lane | do_overtake)[:, None])
    cross_hazard = corridor_hit(veh.pos, cross_threat, 2.2, 15.0)
    # ParkingExit (scen_aux[3] marker): the hemming statics are not hazards
    parking_exit = (((stype == _PARKING_EXIT) & (spec.scen_aux[..., 3] > 0.5)).any(1)
                    & (s_ego < 18.0))
    hazard = close_lead
    hazard = hazard | corridor_hit(st.pos, st.alive & ~(do_overtake | parking_exit)[:, None],
                                   HAZARD_HALF_WIDTH, HAZARD_AHEAD)
    hazard = hazard | corridor_hit(veh.pos, veh.alive & ~moving_veh & ~do_overtake[:, None],
                                   HAZARD_HALF_WIDTH, HAZARD_AHEAD)

    # ---------- crossing-flow stop line: where flow 0's polyline crosses
    # the route ahead; hold short of it while the flow is busy
    start, rows = _route_window(spec, ego.route_idx)
    rwin = take_rows(spec.route_xy, rows)  # [B, W, 2]
    fxy = spec.flow_xy[:, 0]  # [B, F, 2]
    dd = ((rwin[:, :, None, :] - fxy[:, None, :, :]) ** 2).sum(-1)  # [B, W, F]
    per_pt = torch.sqrt(dd.amin(2))  # [B, W]
    cross_off = torch.argmin(per_pt, 1)
    cross_s = (start + cross_off).float()
    crosses = spec.flow_enabled[:, 0] & (take(per_pt, cross_off) < 3.0)
    cross_pt = take(rwin, cross_off)  # [B, 2]
    to_cross = cross_pt[:, None] - veh.pos
    closing_cross = _dot(to_cross, vdir)  # + if heading toward it
    flow = veh.alive & (veh.mode == 1)
    # patience: the junction wait clock widens the accepted gap
    waited = torch.where(stype == _CROSSING_FLOW, state.scenario.aux, 0.0).sum(1)
    horizon = torch.where(waited > 10.0, 0.9, torch.where(waited > 5.0, 1.2, 1.9))
    arr = closing_cross / veh.speed.clamp_min(1.0)
    imminent = flow & (arr > 0.75) & (arr < horizon[:, None])
    in_box = flow & (veh.speed < 2.0) & (
        torch.sqrt(((veh.pos - cross_pt[:, None]) ** 2).sum(-1)) < 8.0)
    flow_busy = (imminent | in_box).any(1)
    yield_cross = crosses & flow_busy & (s_ego > cross_s - 12.0) & (s_ego < cross_s - 6.0)
    # creep guard: drifted just past the hold line, slow, flow busy: stop now
    yield_cross = yield_cross | (crosses & flow_busy & (s_ego >= cross_s - 6.0)
                                 & (s_ego < cross_s - 4.5) & (ego.speed < 3.5))
    # committed: clear the junction briskly, no braking for crossers mid-lane
    in_junction = crosses & (s_ego >= cross_s - 6.0) & (s_ego <= cross_s + 6.0) & ~yield_cross
    v_target = torch.where(in_junction, v_target.clamp_min(CRUISE_SPEED), v_target)
    hazard = hazard | (cross_hazard & ~in_junction)

    # walkers: generous yield box
    relw = wk.pos - ego.pos[:, None]
    fw = _dot(relw, heading[:, None])
    lw_ = _dot(relw, left[:, None])
    closing_w = (lw_ * _dot(wk.vel, left[:, None])) < 0.0
    yield_walk = (wk.alive & (fw > -1.0) & (fw < 13.0) & (lw_.abs() < 5.0)
                  & (closing_w | (lw_.abs() < 2.0))).any(1)

    # ---------- stop signs: brake in each zone until that stop has latched
    n_stops = spec.stop_s.shape[1]
    sign_on = torch.arange(n_stops, device=s_ego.device)[None] < spec.n_stop[:, None]
    in_zone = sign_on & (s_col >= spec.stop_s - 4.0) & (s_col <= spec.stop_s + 4.0)
    must_stop = (in_zone & ~state.criteria.stop_done).any(1)

    # ---------- traffic lights: hold short of the stop line unless green
    t_s = state.t.float() * C.DT
    tl_on = torch.arange(spec.tl_stop_s.shape[1], device=s_ego.device)[None] < spec.n_tl[:, None]
    tl_color = light_state(t_s, spec.tl_offset, spec.tl_green_s, spec.tl_yellow_s, spec.tl_red_s)
    approaching = tl_on & (s_col >= spec.tl_stop_s - 9.0) & (s_col <= spec.tl_stop_s - 1.0)
    hold_light = (approaching & (tl_color != GREEN)).any(1)

    brake_on = hazard | yield_cross | yield_walk | must_stop | hold_light | wait_for_gap
    # commit hard through a junction crossing, and pull away at full throttle
    launching = crosses & (waited > 0.5) & (s_ego > cross_s - 12.0) & (s_ego < cross_s + 6.0)
    pulling_away = (v_target - ego.speed) > 3.0
    throttle_cap = torch.where(in_junction | launching | pulling_away, 1.0, 0.75)
    v_target = torch.where(launching & ~brake_on, v_target.clamp_min(CRUISE_SPEED), v_target)
    throttle = torch.minimum((0.5 * (v_target - ego.speed)).clamp_min(0.0), throttle_cap)
    throttle = torch.where(brake_on, 0.0, throttle)
    brake = torch.where(brake_on, 1.0, 0.0)
    zero = torch.zeros_like(throttle)
    return torch.stack([throttle, steer, brake, zero, zero, zero, zero], -1)
