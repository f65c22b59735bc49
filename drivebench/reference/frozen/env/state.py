"""Scene state: fixed-capacity, alive-masked pools batched over worlds.

Port of gabril_carla_tpu/env/state.py. Every leaf is a tensor whose leading
axis is the world; pool sizes come from constants.py. There is no PRNG key
in the state: an env step takes its random draws as an explicit input
(env.py: DrivingEnv.step).
"""

from __future__ import annotations

import dataclasses

import torch

from . import constants as C


def in_any_window(s: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Inside ANY of the per-world [B, K, 2] route-arclength windows (an empty
    slot has hi <= lo and never matches). ``s`` is [B] or [B, n]; the result
    is bool of ``s``'s shape."""
    shape = (win.shape[0],) + (1,) * (s.dim() - 1) + (win.shape[1],)
    lo = win[..., 0].reshape(shape)
    hi = win[..., 1].reshape(shape)
    s = s.unsqueeze(-1)
    return ((s >= lo) & (s <= hi) & (hi > lo)).any(-1)


class _Leaves:
    """Dataclass helpers: ``replace`` and leaf-wise select."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def tree_where(mask: torch.Tensor, new, old, unchanged=None):
    """Leaf-wise ``where(mask, new, old)`` over two states of one type, with
    the per-world bool ``mask`` [B] broadcast over each leaf. A leaf of
    ``new`` that is the very tensor of ``unchanged`` (default: ``old``) was
    not written, and ``old``'s leaf is kept without a select."""
    if unchanged is None:
        unchanged = old
    if isinstance(new, torch.Tensor):
        if new is unchanged:
            return old
        return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)
    return type(new)(**{f.name: tree_where(mask, getattr(new, f.name), getattr(old, f.name),
                                           getattr(unchanged, f.name))
                        for f in dataclasses.fields(new)})


@dataclasses.dataclass
class EgoState(_Leaves):
    pos: torch.Tensor  # [B, 2] x, y (CARLA map frame, meters)
    yaw: torch.Tensor  # [B] radians
    speed: torch.Tensor  # [B] m/s (forward)
    steer: torch.Tensor  # [B] last applied steer in [-1, 1]
    route_idx: torch.Tensor  # [B] int32, nearest route point (monotonic tracker)


@dataclasses.dataclass
class ActorPool(_Leaves):
    """NPC vehicles & bicycles. kind: 0=car, 1=bicycle. mode: 0=inactive,
    1=flow, 2=lane-follow, 3=scripted. ``gen`` counts respawns of a slot
    (collision dedup tells a new actor in an old slot apart)."""

    pos: torch.Tensor  # [B, N, 2]
    yaw: torch.Tensor  # [B, N]
    speed: torch.Tensor  # [B, N]
    alive: torch.Tensor  # [B, N] bool
    kind: torch.Tensor  # [B, N] int32
    mode: torch.Tensor  # [B, N] int32
    half_extent: torch.Tensor  # [B, N, 2]
    flow_s: torch.Tensor  # [B, N]
    lane_offset: torch.Tensor  # [B, N]
    direction: torch.Tensor  # [B, N] +1 along route, -1 oncoming
    target_speed: torch.Tensor  # [B, N]
    gen: torch.Tensor  # [B, N] int32

    @staticmethod
    def empty(b: int, device, n: int = C.N_VEHICLES) -> "ActorPool":
        f = dict(device=device)
        return ActorPool(
            pos=torch.zeros(b, n, 2, **f), yaw=torch.zeros(b, n, **f),
            speed=torch.zeros(b, n, **f), alive=torch.zeros(b, n, dtype=torch.bool, **f),
            kind=torch.zeros(b, n, dtype=torch.int32, **f),
            mode=torch.zeros(b, n, dtype=torch.int32, **f),
            half_extent=torch.ones(b, n, 2, **f), flow_s=torch.zeros(b, n, **f),
            lane_offset=torch.zeros(b, n, **f), direction=torch.ones(b, n, **f),
            target_speed=torch.zeros(b, n, **f), gen=torch.zeros(b, n, dtype=torch.int32, **f),
        )


@dataclasses.dataclass
class WalkerPool(_Leaves):
    pos: torch.Tensor  # [B, W, 2]
    vel: torch.Tensor  # [B, W, 2] walk velocity vector
    alive: torch.Tensor  # [B, W] bool
    ttl: torch.Tensor  # [B, W] seconds until despawn

    @staticmethod
    def empty(b: int, device, n: int = C.N_WALKERS) -> "WalkerPool":
        return WalkerPool(
            pos=torch.zeros(b, n, 2, device=device), vel=torch.zeros(b, n, 2, device=device),
            alive=torch.zeros(b, n, dtype=torch.bool, device=device),
            ttl=torch.zeros(b, n, device=device),
        )


@dataclasses.dataclass
class StaticPool(_Leaves):
    """Props: accident vehicles, containers, opened doors, parked cars."""

    pos: torch.Tensor  # [B, S, 2]
    yaw: torch.Tensor  # [B, S]
    half_extent: torch.Tensor  # [B, S, 2]
    alive: torch.Tensor  # [B, S] bool


@dataclasses.dataclass
class ScenarioState(_Leaves):
    """Phase machines for the route's K scenario slots."""

    phase: torch.Tensor  # [B, K] int32: 0=waiting for trigger, 1+ type-specific
    timer: torch.Tensor  # [B, K] seconds in the current phase
    next_gap: torch.Tensor  # [B, N_FLOWS] meters until the next flow spawn
    timeout: torch.Tensor  # [B, K] remaining scenario timeout
    timed_out: torch.Tensor  # [B, K] bool, ScenarioTimeoutTest fired
    aux: torch.Tensor  # [B, K] type-specific accumulator

    @staticmethod
    def init(b: int, device, n_flows: int = 2, n_scen: int = 1) -> "ScenarioState":
        return ScenarioState(
            phase=torch.zeros(b, n_scen, dtype=torch.int32, device=device),
            timer=torch.zeros(b, n_scen, device=device),
            next_gap=torch.zeros(b, n_flows, device=device),
            timeout=torch.full((b, n_scen), 240.0, device=device),
            timed_out=torch.zeros(b, n_scen, dtype=torch.bool, device=device),
            aux=torch.zeros(b, n_scen, device=device),
        )


@dataclasses.dataclass
class Criteria(_Leaves):
    """Per-route infraction accumulators (see the JAX package's state.py for
    the reference criteria each field mirrors)."""

    collisions_vehicle: torch.Tensor  # [B] int32 event counts
    collisions_pedestrian: torch.Tensor
    collisions_static: torch.Tensor
    last_collision_id: torch.Tensor  # [B] int32, -1 = none
    last_collision_gen: torch.Tensor  # [B] int32
    last_collision_time: torch.Tensor  # [B] sim seconds of the last event
    last_collision_pos: torch.Tensor  # [B, 2] ego position at the last event
    collision_loc_valid: torch.Tensor  # [B] bool
    red_light: torch.Tensor  # [B] int32
    stop_infraction: torch.Tensor  # [B] int32
    stop_pending: torch.Tensor  # [B] bool
    stop_done: torch.Tensor  # [B, N_STOPS] bool
    outside_lane_m: torch.Tensor  # [B]
    driven_m: torch.Tensor  # [B]
    blocked_time: torch.Tensor  # [B]
    blocked: torch.Tensor  # [B] bool
    deviated: torch.Tensor  # [B] bool
    ms_ego_sum: torch.Tensor  # [B]
    ms_amb_sum: torch.Tensor  # [B]
    ms_ticks: torch.Tensor  # [B]
    ms_ckpt: torch.Tensor  # [B] int32
    ms_penalty: torch.Tensor  # [B]

    @staticmethod
    def init(b: int, device) -> "Criteria":
        def i(v=0):
            return torch.full((b,), v, dtype=torch.int32, device=device)

        def f(v=0.0):
            return torch.full((b,), v, device=device)

        def no():
            return torch.zeros(b, dtype=torch.bool, device=device)

        return Criteria(
            collisions_vehicle=i(), collisions_pedestrian=i(), collisions_static=i(),
            last_collision_id=i(-1), last_collision_gen=i(), last_collision_time=f(-1e9),
            last_collision_pos=torch.full((b, 2), 1e9, device=device),
            collision_loc_valid=no(), red_light=i(), stop_infraction=i(),
            stop_pending=no(), stop_done=torch.zeros(b, C.N_STOPS, dtype=torch.bool, device=device),
            outside_lane_m=f(), driven_m=f(), blocked_time=f(), blocked=no(), deviated=no(),
            ms_ego_sum=f(), ms_amb_sum=f(), ms_ticks=f(), ms_ckpt=i(), ms_penalty=f(1.0),
        )


@dataclasses.dataclass
class SceneState(_Leaves):
    ego: EgoState
    vehicles: ActorPool
    walkers: WalkerPool
    statics: StaticPool
    scenario: ScenarioState
    criteria: Criteria
    t: torch.Tensor  # [B] int32 tick counter
    done: torch.Tensor  # [B] bool


def pair(ref: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """[B, 2] rows of the constant pair (a, b), built on ``ref``'s device
    without a host copy."""
    return torch.stack([torch.full_like(ref, a), torch.full_like(ref, b)], -1)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-world gather: ``x[b, idx[b]]`` for x [B, N, ...] and idx [B], the
    index clamped into [0, N) as JAX clamps an out-of-range gather."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long().clamp(0, x.shape[1] - 1)]


def put(x: torch.Tensor, idx: torch.Tensor, val, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-world masked scatter: ``x[b, idx[b]] = val[b]`` where ``mask[b]``,
    as a select (an out-of-range idx writes nothing, like JAX's dropped
    scatter). ``val`` is [B, ...] or a scalar."""
    hit = torch.arange(x.shape[1], device=x.device)[None] == idx[:, None]
    if mask is not None:
        hit = hit & mask[:, None]
    hit = hit.reshape(hit.shape + (1,) * (x.dim() - 2))
    if isinstance(val, torch.Tensor):
        val = val.to(x.dtype).unsqueeze(1)
    return torch.where(hit, val, x)
