"""Vehicle/walker dynamics: kinematic bicycle ego + polyline-following NPCs.

Port of gabril_carla_tpu/env/dynamics.py, batched over a leading world
axis: a 20 Hz kinematic bicycle for the ego, and NPCs that advance by
arclength along precompiled polylines (gathers and FMAs).
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .state import ActorPool, EgoState, WalkerPool

# Slot partitioning: scripted vehicles own [0, FLOW0_START); flow 0 spawns into
# [FLOW0_START, FLOW1_START); flow 1 into [FLOW1_START, N_VEHICLES).
FLOW0_START = 4
FLOW1_START = 10

# deg2rad in float32, as jnp.deg2rad computes it
_MAX_STEER_RAD = float(np.float32(C.EGO_MAX_STEER_DEG) * np.float32(np.pi / 180))


def ego_step(ego: EgoState, throttle, steer, brake, dt: float = C.DT) -> EgoState:
    """Kinematic bicycle with throttle/brake force model."""
    throttle = throttle.clamp(0.0, 1.0)
    steer = steer.clamp(-1.0, 1.0)
    accel = throttle * C.EGO_MAX_ACCEL - brake * C.EGO_MAX_BRAKE - C.EGO_DRAG * ego.speed
    speed = (ego.speed + accel * dt).clamp(0.0, C.EGO_MAX_SPEED)
    delta = steer * _MAX_STEER_RAD
    yaw = ego.yaw + speed / C.EGO_WHEELBASE * torch.tan(delta) * dt
    heading = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1)
    pos = ego.pos + speed[:, None] * heading * dt
    return ego.replace(pos=pos, yaw=yaw, speed=speed, steer=steer)


def take_rows(xy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``xy[b, idx[b, ...]]`` for xy [B, M, D] and idx [B, ...] -> [B, ..., D]."""
    flat = idx.reshape(idx.shape[0], -1).long()
    out = torch.gather(xy, 1, flat[..., None].expand(-1, -1, xy.shape[-1]))
    return out.reshape(idx.shape + (xy.shape[-1],))


def polyline_point(xy, dirs, s, n_valid):
    """Position + tangent at arclength s [B, ...] on 1 m-spaced polylines
    xy [B, M, 2]; ``n_valid`` [B] valid points."""
    nv = (n_valid.float() - 1.0).reshape((-1,) + (1,) * (s.dim() - 1))
    s = torch.minimum(s.clamp_min(0.0), nv)
    i0 = s.to(torch.int32).clamp(0, xy.shape[1] - 2)
    frac = (s - i0.float())[..., None]
    p = take_rows(xy, i0) * (1 - frac) + take_rows(xy, i0 + 1) * frac
    return p, take_rows(dirs, i0)


def left_normal(d: torch.Tensor) -> torch.Tensor:
    """Unit normal to the vehicle's left in CARLA's y-south frame."""
    return torch.stack([d[..., 1], -d[..., 0]], -1)


def npc_collision_avoidance(pool: ActorPool, ego_pos, ego_yaw, ego_speed, dt: float = C.DT):
    """TrafficManager-style lead-vehicle braking for NPCs: a per-NPC speed
    cap [B, N] (0 where blocked, inf elsewhere). The two regimes (committed
    ego: wide, extrapolated check; slow ego: imminent overlap only) are the
    JAX package's, whose comments give the reasons."""
    n = pool.pos.shape[1]
    hdg = torch.stack([torch.cos(pool.yaw), torch.sin(pool.yaw)], -1)  # [B, N, 2]
    look = 4.0 + pool.speed ** 2 / 9.0  # [B, N]
    ego_fwd = torch.stack([torch.cos(ego_yaw), torch.sin(ego_yaw)], -1)  # [B, 2]

    def blocked_by(p, f_scale, lat):
        rel_e = p[:, None, :] - pool.pos
        f_e = (rel_e * hdg).sum(-1)
        l_e = rel_e[..., 0] * hdg[..., 1] - rel_e[..., 1] * hdg[..., 0]
        return (f_e > 0.0) & (f_e < f_scale * look) & (l_e.abs() < lat)

    committed = (ego_speed > 1.5)[:, None]
    wide = blocked_by(ego_pos, 1.3, 3.0)
    not_leader = (hdg * ego_fwd[:, None, :]).sum(-1) < 0.7
    future = torch.zeros_like(wide)
    for k in (0.8, 1.6, 2.4):
        future = future | blocked_by(ego_pos + ego_fwd * ego_speed[:, None] * k, 1.3, 3.0)
    wide = wide | (future & not_leader)
    narrow = blocked_by(ego_pos, 1.0, 2.2)
    block_e = narrow | (wide & committed)
    # vs other NPCs
    rel = pool.pos[:, None, :, :] - pool.pos[:, :, None, :]  # [B, N, N, 2]
    f = (rel * hdg[:, :, None, :]).sum(-1)
    l = rel[..., 0] * hdg[:, :, None, 1] - rel[..., 1] * hdg[:, :, None, 0]
    eye = torch.eye(n, dtype=torch.bool, device=pool.pos.device)
    others = pool.alive[:, None, :] & ~eye
    block_n = (others & (f > 0.0) & (f < look[:, :, None] * 0.8) & (l.abs() < 1.5)).any(-1)
    return torch.where(block_e | block_n, 0.0, float("inf"))


def vehicles_step(pool: ActorPool, spec, ego_pos, ego_yaw, ego_speed, dt: float = C.DT) -> ActorPool:
    """Advance NPC vehicles by mode.

    mode 1: advance along the slot's flow polyline (flow 0 below FLOW1_START,
            else flow 1); despawn past the end.
    mode 2: lane-follow the route at ``lane_offset``, signed ``direction``.
    mode 0/3: stationary (scenarios.py rewrites mode/target/offset).
    """
    b, n = pool.speed.shape
    dev = pool.speed.device
    speed = torch.where(pool.alive, pool.speed, 0.0)
    target = torch.minimum(pool.target_speed,
                           npc_collision_avoidance(pool, ego_pos, ego_yaw, ego_speed, dt))
    # first-order longitudinal control, emergency-level braking bound
    speed = speed + (target - speed).clamp(-9.0 * dt, 2.5 * dt)
    speed = torch.where(pool.mode > 0, speed, 0.0)
    new_s = pool.flow_s + pool.direction * speed * dt

    flow_id = (torch.arange(n, device=dev) >= FLOW1_START).long()  # [N]
    f_pts = spec.flow_xy.shape[2]
    flen = spec.flow_len[:, flow_id]  # [B, N]

    def flow_point(s):
        s = torch.minimum(s.clamp_min(0.0), flen)
        i0 = s.to(torch.int32).clamp(0, f_pts - 2)
        frac = (s - i0.float())[..., None]
        # index into the two flows' points laid end to end
        base = flow_id[None] * f_pts + i0
        fxy = spec.flow_xy.reshape(b, -1, 2)
        fdir = spec.flow_dir.reshape(b, -1, 2)
        p = take_rows(fxy, base) * (1 - frac) + take_rows(fxy, base + 1) * frac
        return p, take_rows(fdir, base)

    flow_pos, flow_d = flow_point(new_s)
    route_end = spec.n_route.float()[:, None] - 1.0
    s_r = torch.minimum(new_s.clamp_min(0.0), route_end)
    i0 = s_r.to(torch.int32).clamp(0, spec.route_xy.shape[1] - 2)
    frac = (s_r - i0.float())[..., None]
    route_pos = take_rows(spec.route_xy, i0) * (1 - frac) + take_rows(spec.route_xy, i0 + 1) * frac
    route_d = take_rows(spec.route_dir, i0)
    lane_pos = route_pos + pool.lane_offset[..., None] * left_normal(route_d)
    lane_d = route_d * pool.direction[..., None]

    is_flow = pool.mode == 1
    is_lane = pool.mode == 2
    moving = is_flow | is_lane
    pos = torch.where(is_flow[..., None], flow_pos,
                      torch.where(is_lane[..., None], lane_pos, pool.pos))
    d = torch.where(is_flow[..., None], flow_d, torch.where(is_lane[..., None], lane_d, 0.0))
    yaw = torch.where(moving, torch.atan2(d[..., 1], d[..., 0]), pool.yaw)

    # despawn at polyline end
    end = torch.where(is_flow, flen, route_end)
    alive = pool.alive & ~(moving & (new_s >= end - 0.5) & (pool.direction > 0))
    alive = alive & ~(moving & (new_s <= 0.5) & (pool.direction < 0))
    return pool.replace(pos=pos, yaw=yaw, speed=speed, alive=alive,
                        flow_s=torch.where(moving, new_s, pool.flow_s))


def walkers_step(pool: WalkerPool, dt: float = C.DT) -> WalkerPool:
    pos = torch.where(pool.alive[..., None], pool.pos + pool.vel * dt, pool.pos)
    ttl = pool.ttl - dt
    alive = pool.alive & (ttl > 0.0)
    return pool.replace(pos=pos, ttl=ttl, alive=alive)
