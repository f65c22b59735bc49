"""Ambient background traffic (BackgroundBehavior-lite), batched over worlds.

Port of gabril_carla_tpu/env/ambient.py: a fixed block of lane-follow slots
recycled around the ego by masked updates. Same-direction slots
[AMBIENT_SAME, AMBIENT_OPP) follow the route at offset 0; opposite slots
[AMBIENT_OPP, N_VEHICLES) run the adjacent lane toward the ego. Keep-clear
windows despawn ambient actors and block respawns; same-direction actors
hold at red/yellow lights and recycle once far behind the ego.
"""

from __future__ import annotations

import torch

from . import constants as C
from .dynamics import FLOW0_START, FLOW1_START, take_rows
from .state import ActorPool, SceneState, in_any_window, pair, put, take
from .traffic_lights import GREEN, RED, light_state

AMBIENT_SAME = C.N_VEHICLES - C.N_AMBIENT_SAME - C.N_AMBIENT_OPP  # 16
AMBIENT_OPP = AMBIENT_SAME + C.N_AMBIENT_SAME  # 20

# initial placement relative to the ego spawn (meters of route arclength)
_SAME_INIT = (-25.0, 30.0, 60.0, 90.0)
_OPP_INIT = (40.0, 70.0, 100.0, 130.0)
BEHIND_DESPAWN = 60.0  # same-dir actors this far behind the ego recycle
OPP_BEHIND_DESPAWN = 15.0  # opposite traffic passes the ego and recycles


def _opp_ok_at(spec, s):
    """Opposite-lane validity at arclength s [B, ...] (index clamped)."""
    i = s.to(torch.int32).clamp(0, spec.opp_ok.shape[1] - 1)
    return torch.gather(spec.opp_ok, 1, i.reshape(i.shape[0], -1).long()).reshape(s.shape)


def ambient_reset(spec, vehicles: ActorPool) -> ActorPool:
    """Populate the ambient block at episode start."""
    b = vehicles.pos.shape[0]
    dev = vehicles.pos.device
    route_end = spec.n_route.float()[:, None] - 2.0
    v = vehicles
    for lo, hi, s_init, direction, off, despawn_lo in (
        (AMBIENT_SAME, AMBIENT_OPP, _SAME_INIT, 1.0, 0.0, 1.0),
        (AMBIENT_OPP, C.N_VEHICLES, _OPP_INIT, -1.0, C.LANE_WIDTH, 20.0),
    ):
        n = hi - lo
        s = torch.minimum(torch.tensor(s_init, device=dev).expand(b, n).clamp_min(0.0), route_end)
        win = spec.amb_clear if direction > 0 else spec.amb_opp_clear
        live = (spec.amb_enabled[:, None] & (s > despawn_lo) & (s < route_end - 2.0)
                & ~in_any_window(s, win))
        if direction < 0:  # opposite lane must be geometrically valid here
            live = live & _opp_ok_at(spec, s)
        i = s.to(torch.int32).clamp(0, spec.route_xy.shape[1] - 2)
        p = take_rows(spec.route_xy, i)
        d = take_rows(spec.route_dir, i)
        p = p + off * torch.stack([d[..., 1], -d[..., 0]], -1)  # +left normal
        yaw = torch.atan2(d[..., 1] * direction, d[..., 0] * direction)

        def block(x, val):
            out = x.clone()
            out[:, lo:hi] = val
            return out

        v = v.replace(
            pos=block(v.pos, torch.where(live[..., None], p, v.pos[:, lo:hi])),
            yaw=block(v.yaw, torch.where(live, yaw, v.yaw[:, lo:hi])),
            # spawn standing, like the ego (a full-speed fleet at t=0 would
            # bias the first MIN_SPEED checkpoint against the ego)
            speed=block(v.speed, 0.0),
            target_speed=block(v.target_speed, torch.where(live, spec.amb_speed[:, None], 0.0)),
            alive=block(v.alive, live),
            mode=block(v.mode, torch.where(live, 2, 0).to(torch.int32)),
            kind=block(v.kind, 0),
            flow_s=block(v.flow_s, torch.where(live, s, 0.0)),
            lane_offset=block(v.lane_offset, off),
            direction=block(v.direction, direction),
            half_extent=block(v.half_extent, torch.where(
                live[..., None], pair(s, 2.4, 0.95), v.half_extent[:, lo:hi])),
        )
    return v


def ambient_step(spec, state: SceneState, u_same: torch.Tensor, u_opp: torch.Tensor) -> SceneState:
    """Recycle ambient actors around the ego and apply keep-clear windows;
    ``u_same``/``u_opp`` [B] in [0, 1) place this tick's respawns."""
    v = state.vehicles
    dev = v.pos.device
    ego_s = state.ego.route_idx.float()
    route_end = spec.n_route.float() - 2.0
    t_s = state.t.float() * C.DT

    idx = torch.arange(C.N_VEHICLES, device=dev)[None]
    is_same = (idx >= AMBIENT_SAME) & (idx < AMBIENT_OPP)
    is_opp = idx >= AMBIENT_OPP
    is_amb = is_same | is_opp

    # ---- clears + far-behind despawn + invalid opposite-lane segments
    in_clear = torch.where(is_same, in_any_window(v.flow_s, spec.amb_clear),
                           in_any_window(v.flow_s, spec.amb_opp_clear))
    behind = torch.where(is_same, ego_s[:, None] - v.flow_s > BEHIND_DESPAWN,
                         ego_s[:, None] - v.flow_s > OPP_BEHIND_DESPAWN)
    bad_opp = is_opp & ~_opp_ok_at(spec, v.flow_s)
    kill = is_amb & v.alive & (in_clear | behind | bad_opp)
    alive = v.alive & ~kill

    # ---- light compliance for same-direction ambient
    color = light_state(t_s, spec.tl_offset, spec.tl_green_s, spec.tl_yellow_s, spec.tl_red_s)
    k_tl = spec.tl_stop_s.shape[1]
    tl_on = (torch.arange(k_tl, device=dev)[None] < spec.n_tl[:, None]) & (color != GREEN)
    gap = spec.tl_stop_s[:, None, :] - v.flow_s[..., None]  # [B, N, K]
    hold = (tl_on[:, None, :] & (gap > 0.5) & (gap < 8.0)).any(-1) & is_same
    amb_speed = spec.amb_speed[:, None]
    target = torch.where(is_amb & alive, torch.where(hold, 0.0, amb_speed), v.target_speed)
    target = torch.where(is_amb & ~alive, 0.0, target)

    # ---- ambient junction crossing traffic (flow slot 0 under jct_flow):
    # hold short of the ego corridor while the crossing road has red, or,
    # unsignalized, while the ego approaches; recomputed every tick
    is_jf = (idx >= FLOW0_START) & (idx < FLOW1_START) & spec.jct_flow[:, None]
    sig = spec.jct_signal
    col_sig = take(color, sig.clamp(0, k_tl - 1))
    ego_near = (ego_s > spec.jct_cross_s - 35.0) & (ego_s < spec.jct_cross_s + 6.0)
    ego_close = (ego_s - spec.jct_cross_s).abs() < 12.0
    ego_threat = ego_near & ((state.ego.speed > 1.0) | ego_close)
    blocked = torch.where(sig >= 0, col_sig != RED, ego_threat)
    hold_s = spec.jct_hold_s[:, None]
    at_hold = (v.flow_s < hold_s) & (v.flow_s > hold_s - 14.0)
    jf_target = torch.where(at_hold & blocked[:, None], 0.0, spec.flow_speed[:, :1])
    target = torch.where(is_jf & v.alive, jf_target, target)

    # ---- respawn one dead ambient slot per direction ahead of the ego
    def respawn(vv, block_lo, block_hi, direction, off, u):
        alv = vv.alive
        free = (idx >= block_lo) & (idx < block_hi) & ~alv
        has_free = free.any(-1)
        slot = free.to(torch.uint8).argmax(-1)
        s_new = ego_s + torch.clamp_min(u * (140.0 - 65.0) + 65.0, 65.0)
        win = spec.amb_clear if direction > 0 else spec.amb_opp_clear
        ok = spec.amb_enabled & has_free & (s_new < route_end - 5.0) & ~in_any_window(s_new, win)
        if direction < 0:
            ok = ok & _opp_ok_at(spec, s_new)
        # don't drop a car onto an existing one
        i0 = s_new.to(torch.int32).clamp(0, spec.route_xy.shape[1] - 2)
        d = take(spec.route_dir, i0)
        p = take(spec.route_xy, i0) + off * torch.stack([d[:, 1], -d[:, 0]], -1)
        rel = vv.pos - p[:, None, :]
        dist = torch.where(alv, torch.sqrt((rel * rel).sum(-1)), float("inf"))
        ok = ok & (dist.min(-1).values > 12.0)
        return vv.replace(
            pos=put(vv.pos, slot, p, ok),
            yaw=put(vv.yaw, slot, torch.atan2(d[:, 1] * direction, d[:, 0] * direction), ok),
            speed=put(vv.speed, slot, spec.amb_speed, ok),
            alive=put(vv.alive, slot, True, ok),
            mode=put(vv.mode, slot, 2, ok),
            kind=put(vv.kind, slot, 0, ok),
            flow_s=put(vv.flow_s, slot, s_new, ok),
            lane_offset=put(vv.lane_offset, slot, off, ok),
            direction=put(vv.direction, slot, direction, ok),
            half_extent=put(vv.half_extent, slot, pair(s_new, 2.4, 0.95), ok),
            # recycled slot = physically new actor (collision-dedup identity)
            gen=put(vv.gen, slot, take(vv.gen, slot) + 1, ok),
            target_speed=put(vv.target_speed, slot, spec.amb_speed, ok),
        )

    v = v.replace(alive=alive, target_speed=target)
    v = respawn(v, AMBIENT_SAME, AMBIENT_OPP, 1.0, 0.0, u_same)
    v = respawn(v, AMBIENT_OPP, C.N_VEHICLES, -1.0, C.LANE_WIDTH, u_opp)
    return state.replace(vehicles=v)


def ambient_speeds(vehicles: ActorPool, spec):
    """(mean speed of alive ambient actors, any alive) per world — the
    background reference speed of MinimumSpeedRouteTest. Junction crossing
    traffic (flow slot 0 under jct_flow) counts as background too."""
    idx = torch.arange(C.N_VEHICLES, device=vehicles.pos.device)[None]
    amb = (idx >= AMBIENT_SAME) | (spec.jct_flow[:, None] & (idx >= FLOW0_START) & (idx < FLOW1_START))
    alive = vehicles.alive & amb
    n = alive.float().sum(-1)
    mean = torch.where(alive, vehicles.speed, 0.0).sum(-1) / n.clamp_min(1.0)
    return mean, n > 0
