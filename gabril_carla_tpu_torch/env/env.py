"""DrivingEnv: reset/step over (WorldSpec, SceneState), batched over worlds.

Port of gabril_carla_tpu/env/env.py. One step is

    step : (spec, state, action [B, 7], draws [B, 4]) -> state'

Action codec parity with the reference agent (autonomous_agent.py:169-206):
[throttle, steer, brake, handbrake, reverse, manual_gear, gear], throttle
clipped to [0, 1], steer to [-1, 1], brake binarized at > 0.8.

``draws`` are the step's four uniform numbers in [0, 1): the two flow gaps
and the same-direction and opposite ambient respawn offsets, in that order
(DRAWS_PER_STEP). The JAX package draws them from the state's PRNG key;
here the caller owns the randomness (eval/rollout.py draws them from a
torch.Generator, the parity tests replay JAX's).
"""

from __future__ import annotations

import torch

from . import constants as C
from .ambient import ambient_reset, ambient_step
from .criteria import completion_pct, criteria_step
from .dynamics import FLOW0_START, FLOW1_START, ego_step, take_rows, vehicles_step, walkers_step
from .scenarios import scenario_step
from .state import ActorPool, Criteria, EgoState, SceneState, ScenarioState, StaticPool, WalkerPool, tree_where
from .world import N_FLOWS

DRAWS_PER_STEP = 4  # flow-0 gap, flow-1 gap, ambient same, ambient opposite


def decode_action(action7: torch.Tensor):
    """7-vector -> (throttle, steer, brake) with the reference's clamps.
    NaN-guarded: a diverged policy must not poison the sim state."""
    action7 = torch.nan_to_num(action7, nan=0.0, posinf=1.0, neginf=-1.0)
    throttle = action7[..., 0].clamp(0.0, 1.0)
    steer = action7[..., 1].clamp(-1.0, 1.0)
    brake = (action7[..., 2] > 0.8).float()
    return throttle, steer, brake


class DrivingEnv:
    """Stateless env: every method is a function of (spec, state)."""

    def reset(self, spec) -> SceneState:
        b = spec.route_len.shape[0]
        dev = spec.route_len.device
        vehicles = ActorPool.empty(b, dev).replace(
            pos=spec.veh_pos.clone(), yaw=spec.veh_yaw.clone(), kind=spec.veh_kind.clone(),
            half_extent=spec.veh_extent.clone(), alive=spec.veh_alive.clone())
        # pre-populate flows (ActorFlow initial_actors=True semantics)
        f_pts = spec.flow_xy.shape[2]
        for flow in range(N_FLOWS):
            lo = FLOW0_START if flow == 0 else FLOW1_START
            hi = FLOW1_START if flow == 0 else C.N_VEHICLES
            mean_gap = 0.5 * (spec.flow_gap_lo[:, flow] + spec.flow_gap_hi[:, flow]) + 1e-3
            k = torch.arange(hi - lo, device=dev, dtype=torch.float32)[None]
            s0 = spec.flow_len[:, flow, None] - (k + 1.0) * mean_gap[:, None]
            live = spec.flow_enabled[:, flow, None] & (s0 > 0.0)
            s0 = s0.clamp_min(0.0)
            i = s0.to(torch.int32).clamp(0, f_pts - 2)
            p = take_rows(spec.flow_xy[:, flow], i)
            d = take_rows(spec.flow_dir[:, flow], i)
            kind = spec.flow_kind[:, flow, None]
            bike = kind == 1
            extent = torch.stack([torch.where(bike, 0.9, 2.4), torch.where(bike, 0.4, 0.95)], -1)
            speed = spec.flow_speed[:, flow, None]

            def block(x, val):
                out = x.clone()
                out[:, lo:hi] = val
                return out

            v = vehicles
            vehicles = v.replace(
                pos=block(v.pos, torch.where(live[..., None], p, v.pos[:, lo:hi])),
                yaw=block(v.yaw, torch.where(live, torch.atan2(d[..., 1], d[..., 0]), v.yaw[:, lo:hi])),
                speed=block(v.speed, torch.where(live, speed, 0.0)),
                target_speed=block(v.target_speed, torch.where(live, speed, 0.0)),
                alive=block(v.alive, live),
                mode=block(v.mode, torch.where(live, 1, 0).to(torch.int32)),
                kind=block(v.kind, torch.where(live, kind, 0)),
                flow_s=block(v.flow_s, s0),
                half_extent=block(v.half_extent, torch.where(live[..., None], extent,
                                                             v.half_extent[:, lo:hi])),
            )

        vehicles = ambient_reset(spec, vehicles)
        statics = StaticPool(pos=spec.statics_pos.clone(), yaw=spec.statics_yaw.clone(),
                             half_extent=spec.statics_extent.clone(),
                             alive=spec.statics_alive.clone())
        zero = torch.zeros(b, device=dev)
        return SceneState(
            ego=EgoState(pos=spec.spawn_pos.clone(), yaw=spec.spawn_yaw.clone(), speed=zero,
                         steer=zero.clone(),
                         route_idx=torch.zeros(b, dtype=torch.int32, device=dev)),
            vehicles=vehicles,
            walkers=WalkerPool.empty(b, dev),
            statics=statics,
            scenario=ScenarioState.init(b, dev, N_FLOWS, n_scen=spec.scenario_type.shape[1]).replace(
                next_gap=0.5 * (spec.flow_gap_lo + spec.flow_gap_hi)),
            criteria=Criteria.init(b, dev),
            t=torch.zeros(b, dtype=torch.int32, device=dev),
            done=torch.zeros(b, dtype=torch.bool, device=dev),
        )

    def step(self, spec, state: SceneState, action7: torch.Tensor, draws: torch.Tensor) -> SceneState:
        prev = state
        throttle, steer, brake = decode_action(action7)
        state = scenario_step(spec, state, draws[:, :N_FLOWS])
        state = ambient_step(spec, state, draws[:, N_FLOWS], draws[:, N_FLOWS + 1])
        state = state.replace(
            vehicles=vehicles_step(state.vehicles, spec, state.ego.pos, state.ego.yaw,
                                   state.ego.speed),
            walkers=walkers_step(state.walkers),
            ego=ego_step(state.ego, throttle, steer, brake),
        )
        state = criteria_step(spec, state)

        pct = completion_pct(spec, state)
        timeout_s = (spec.route_len / C.TIMEOUT_SPEED).clamp_min(C.MIN_ROUTE_TIMEOUT)
        done = ((pct >= 100.0) | state.criteria.deviated | state.criteria.blocked
                | (state.t.float() * C.DT > timeout_s))
        state = state.replace(t=state.t + 1, done=done)
        # freeze the world after done (scores are read from the final state)
        return tree_where(prev.done, prev, state)
