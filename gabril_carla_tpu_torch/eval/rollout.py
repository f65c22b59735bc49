"""Closed-loop evaluation: render -> heat -> policy -> env step, batched
over worlds.

Port of gabril_carla_tpu/eval/rollout.py. Where the JAX package scans one
world's tick and vmaps it, every tick here runs all worlds at once in a
Python loop: the render kernel once per tick (and once at reset), the gaze
heat where the method needs it, the policy on the stacked frames, then the
env step.

Heat comes from a frozen gaze predictor (``gaze_predictor_apply``, its
output clamped to [0, 1], bc_agent.py:275-298) or from the scene graph
(``use_analytic_gaze``: ops/raster.py analytic_gaze splatted at 180x320).
``confounded`` runs the two-pass predict -> overlay -> re-predict of
bc_agent.py:321-352 on the one rendered frame; the overlaid frame stays in
the ring.

Parity details kept: 10 warm-up no-op ticks (bc_agent.py:404), hard stop at
fps*100 = 2000 ticks (bc_agent.py:407-411), a float32 [H, W, S] frame ring
fed to the policy like training's frame stack (the policy casts to its
compute dtype itself), brake binarization in the codec.

Randomness: each env step takes four uniforms per world (env.DRAWS_PER_STEP).
The rollout takes one threefry key per world, as JAX's vmapped
``rollout(spec, params, key)`` does (JAX :129), and draws JAX's numbers for
it on the host (utils/prng.py ``env_draws``). ``rollout_routes`` gives world
i the key ``split(key, n)[i]`` (JAX :150-153), so a world's draws do not
depend on how the worlds are sharded.
With a mesh, each 'data' rank rolls its ``n / data`` worlds and every rank
gets all ``n`` back (JAX's ``P("data")`` placement of the specs).

Under torch.profiler the call, its draws, its reset, each tick and each
tick's stages are spans (utils/profiling.py ``span``: ``rollout.call``,
``rollout.tick``, ``rollout.render`` and so on); with no profiler running
each costs one flag check.
"""

from __future__ import annotations

import numpy as np
import torch

from ..env.env import DrivingEnv
from ..env.world import spec_rows, to_torch
from ..ops.heatmap import GazeHeatmapper
from ..ops.raster import analytic_gaze, confounded_overlay, render_frame
from ..parallel.mesh import all_gather_rows, data_rank, data_size
from ..utils.prng import env_draws, split
from ..utils.profiling import span

WARMUP_STEPS = 10
HARD_STOP = 2000  # = fps * 100


def needs_heat(cfg) -> bool:
    """Whether the policy of ``cfg`` takes gaze heat at eval: the gaze
    methods Mask, ViSaRL, AGIL and the dropouts GMD, IGMD."""
    return cfg.gaze["method"] in ("Mask", "ViSaRL", "AGIL") or cfg.dropout["method"] in ("GMD", "IGMD")


def make_rollout_fn(policy_fn, cfg, steps: int = HARD_STOP, use_analytic_gaze: bool = False,
                    gaze_predictor_apply=None, confounded: bool = False,
                    return_frames: bool = False, far_decimate: bool = False,
                    lower_window: bool = False):
    """Build rollout(spec, params, keys) -> (final state, trace): ``keys``
    [B, 2] uint32 are the worlds' threefry keys (utils/prng.py), trace is
    the ego positions [steps, B, 2], or the rendered frames [steps, B, H, W]
    with ``return_frames``. ``rollout.steps`` is ``steps``. ``far_decimate``
    and ``lower_window`` go to every ``render_frame`` call.

    policy_fn(params, obs [B, H, W, S], heat [B, H, W, S] or None) -> [B, 7]
    actions. gaze_predictor_apply(params["gaze_predictor"], obs) -> [B, H,
    W, 1] heat, when the method needs one.
    """
    s = cfg.data["frame_stack"]
    env = DrivingEnv()
    heat_on = needs_heat(cfg)
    if heat_on and gaze_predictor_apply is None and not use_analytic_gaze:
        # zero heat would silently drive on an all-black input (Mask) or
        # garbage-averaged latents (AGIL); the reference always runs the
        # gaze predictor here (bc_agent.py:275-298)
        raise ValueError(
            f"gaze method {cfg.gaze['method']!r} / dropout {cfg.dropout['method']!r} "
            "needs gaze heat at eval: pass gaze_predictor_apply (frozen predictor, "
            "bc_agent.py:275-298 parity) or set use_analytic_gaze=True")
    heatmapper = None
    if heat_on and gaze_predictor_apply is None:
        heatmapper = GazeHeatmapper(img_height=180, img_width=320,
                                    gaze_sigma=cfg.gaze.get("mask_sigma", 30.0),
                                    maxpoints=cfg.gaze.get("max_points", 5))

    def render(spec, state):
        return render_frame(spec, state, far_decimate=far_decimate, lower_window=lower_window)

    def compute_heat(spec, state, params, obs):
        if not heat_on:
            return None
        with span("rollout.heat"):
            if gaze_predictor_apply is not None:
                # the UNet head is an unbounded 1x1 conv: clamp (bc_agent.py:277-278)
                pred = gaze_predictor_apply(params["gaze_predictor"], obs).clamp(0.0, 1.0)
                return pred.repeat(1, 1, 1, s)
            coords = analytic_gaze(spec, state, heatmapper.maxpoints)
            return heatmapper.heatmaps(coords)[..., None].repeat(1, 1, 1, s)

    @torch.inference_mode()
    def rollout(spec, params, keys):
        with span("rollout.call"):
            b = spec.route_len.shape[0]
            dev = spec.route_len.device
            keys = np.asarray(keys, np.uint32)
            if keys.shape != (b, 2):
                raise ValueError(f"keys must be [{b}, 2] threefry keys, got {keys.shape}")
            with span("rollout.draws"):
                draws = torch.from_numpy(env_draws(keys, steps)).to(dev)
            with span("rollout.reset"):
                state = env.reset(spec)
                frames = render(spec, state)[..., None].repeat(1, 1, 1, s)  # [B, H, W, S]
                # warm-up no-op: full brake (noop_control, autonomous_agent.py:194-206)
                noop = torch.zeros(7, device=dev)
                noop[2] = 1.0
            trace = []
            for t in range(steps):
                with span("rollout.tick"):
                    with span("rollout.render"):
                        frame = render(spec, state)
                    with span("rollout.ring"):
                        frames = torch.cat([frames[..., 1:], frame[..., None]], -1)
                    heat = compute_heat(spec, state, params, frames)
                    with span("rollout.policy"):
                        action = policy_fn(params, frames, heat)
                    if confounded:
                        # predict -> overlay -> re-predict; the overlaid frame stays in
                        # the ring, so older stack entries keep their own overlays
                        with span("rollout.overlay"):
                            overlaid = confounded_overlay(frame, action)
                            frames = torch.cat([frames[..., :-1], overlaid[..., None]], -1)
                        heat = compute_heat(spec, state, params, frames)
                        with span("rollout.policy"):
                            action = policy_fn(params, frames, heat)
                    with span("rollout.noop"):
                        action = torch.where((state.t < WARMUP_STEPS)[:, None], noop, action)
                    with span("rollout.env_step"):
                        state = env.step(spec, state, action, draws[t])
                    trace.append(frame if return_frames else state.ego.pos)
            return state, torch.stack(trace)

    rollout.steps = steps
    return rollout


def to_device(params: dict, device) -> dict:
    """A state dict, or one with a nested ``gaze_predictor`` state dict,
    moved to ``device``."""
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def rollout_routes(specs, params, rollout_fn, key, device="cuda", mesh=None):
    """Run ``rollout_fn`` (make_rollout_fn) over the n worlds of a stacked
    numpy WorldSpec (env/world.py: load_benchmark_specs / stack_specs) on
    ``device``, with ``params`` moved there and world i's env draws JAX's
    for the key ``split(key, n)[i]`` (``key``: a threefry key,
    utils/prng.py prng_key).

    ``mesh`` (parallel/mesh.py): 'data' rank r rolls worlds [r * m, (r + 1)
    * m), m = n / data, on their keys, then the final states
    and the traces are gathered so every rank returns all n worlds."""
    n = specs.route_len.shape[0]
    keys = split(key, n)
    rows = np.arange(n)
    if mesh is not None:
        d = data_size(mesh)
        if n % d:
            raise ValueError(f"{n} worlds do not split over {d} 'data' ranks")
        m = n // d
        rows = rows[data_rank(mesh) * m:(data_rank(mesh) + 1) * m]
    spec = to_torch(spec_rows(specs, rows), device)
    state, trace = rollout_fn(spec, to_device(params, device), keys[rows])
    if mesh is None:
        return state, trace
    return all_gather_rows(state, mesh), all_gather_rows(trace, mesh, dim=1)
