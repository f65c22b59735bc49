"""Closed-loop evaluation: render -> policy -> env step, batched over worlds.

Port of gabril_carla_tpu/eval/rollout.py. Where the JAX package scans one
world's tick and vmaps it, every tick here runs all worlds at once in a
Python loop: the render kernel once per tick (and once at reset), the
policy on the stacked frames, then the env step.

Parity details kept: 10 warm-up no-op ticks (bc_agent.py:404), hard stop at
fps*100 = 2000 ticks (bc_agent.py:407-411), a float32 [H, W, S] frame ring
fed to the policy like training's frame stack (the policy casts to its
compute dtype itself), brake binarization in the codec.

Randomness: each env step takes four uniforms per world (env.DRAWS_PER_STEP),
drawn from a caller-seeded torch.Generator on the worlds' device, or given
outright as ``draws [steps, B, 4]`` (the parity tests replay JAX's).
"""

from __future__ import annotations

import torch

from ..env.env import DRAWS_PER_STEP, DrivingEnv
from ..env.world import to_torch
from ..ops.raster import render_frame

WARMUP_STEPS = 10
HARD_STOP = 2000  # = fps * 100


def make_rollout_fn(policy_fn, cfg, steps: int = HARD_STOP, use_analytic_gaze: bool = False,
                    gaze_predictor_apply=None, confounded: bool = False,
                    return_frames: bool = False, far_decimate: bool = False,
                    lower_window: bool = False):
    """Build rollout(spec, params, generator=None, draws=None) -> (final
    state, trace): trace is the ego positions [steps, B, 2], or the rendered
    frames [steps, B, H, W] with ``return_frames``. ``far_decimate`` and
    ``lower_window`` go to every ``render_frame`` call.

    policy_fn(params, obs [B, H, W, S]) -> [B, 7] actions.
    """
    if use_analytic_gaze or gaze_predictor_apply is not None or confounded:
        raise NotImplementedError("analytic gaze, the gaze predictor and the confounded "
                                  "two-pass are queued in ROADMAP.md (port queue)")
    s = cfg.data["frame_stack"]
    env = DrivingEnv()

    def render(spec, state):
        return render_frame(spec, state, far_decimate=far_decimate, lower_window=lower_window)

    @torch.inference_mode()
    def rollout(spec, params, generator: torch.Generator | None = None,
                draws: torch.Tensor | None = None):
        b = spec.route_len.shape[0]
        dev = spec.route_len.device
        if draws is None:
            if generator is None:
                raise ValueError("rollout: pass a seeded torch.Generator or explicit draws")
            draws = torch.rand((steps, b, DRAWS_PER_STEP), generator=generator, device=dev)
        if draws.shape != (steps, b, DRAWS_PER_STEP):
            raise ValueError(f"draws must be [{steps}, {b}, {DRAWS_PER_STEP}], got {tuple(draws.shape)}")
        state = env.reset(spec)
        frames = render(spec, state)[..., None].repeat(1, 1, 1, s)  # [B, H, W, S]
        # warm-up no-op: full brake (noop_control, autonomous_agent.py:194-206)
        noop = torch.zeros(7, device=dev)
        noop[2] = 1.0
        trace = []
        for t in range(steps):
            frame = render(spec, state)
            frames = torch.cat([frames[..., 1:], frame[..., None]], -1)
            action = policy_fn(params, frames)
            action = torch.where((state.t < WARMUP_STEPS)[:, None], noop, action)
            state = env.step(spec, state, action, draws[t])
            trace.append(frame if return_frames else state.ego.pos)
        return state, torch.stack(trace)

    return rollout


def rollout_routes(specs, params, rollout_fn, seed: int = 0, draws=None, device="cuda"):
    """Run ``rollout_fn`` over a stacked numpy WorldSpec (env/world.py:
    load_benchmark_specs / stack_specs) on ``device``, with ``params`` moved
    there and the step draws from a generator seeded with ``seed``."""
    spec = to_torch(specs, device)
    params = {k: v.to(device) for k, v in params.items()}
    generator = torch.Generator(device=device).manual_seed(seed)
    return rollout_fn(spec, params, generator=generator, draws=draws)
