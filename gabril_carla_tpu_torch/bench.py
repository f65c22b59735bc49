"""Rendered closed-loop env steps/s on one card (port of the JAX repo's
bench.py).

    python -m gabril_carla_tpu_torch.bench [n_worlds] [n_steps] [--synthetic]
        [--skip_policy] [--skip_render] [--profile DIR] [--device cuda|cpu]

The loop of bench.py:160-205, batched over worlds: each tick renders the
camera frame (ops/raster.py; the render kernel csrc/render.cu on a CUDA
tensor), casts it to the policy's compute dtype, rotates the frame ring,
runs the full-width bf16 BC policy (gaze "None") on the stacked frames and
steps the env. The ring starts as ``frame_stack`` zero frames and the
policy's action drives from tick 0: there is no reset frame and no warm-up
no-op, unlike eval/rollout.py. Each world's env draws are JAX's for its key
of ``split(prng_key(0), n_worlds)`` (utils/prng.py ``env_draws``, the chain
of JAX's ``env.step(..., key=None)``). The worlds are the 20 real routes
tiled to ``n_worlds`` (bench.py:73-81), or bench.py:82-98's synthetic sine
routes with ``--synthetic``.

One untimed warm-up run, then one timed run on the host clock ending in a
synchronize (bench.py:225-227). Its last stdout line is bench.py's JSON:
``{"metric", "value", "unit", "vs_baseline", "mode"}``, ``mode`` tagged
``+skip_policy`` / ``+skip_render`` for the stage-share probes
(bench.py:118-124: shares by subtraction). stderr gets the card's name and
power limit, the render kernel's launches in the timed run (it must launch
once a tick), the run's CUDA-event time, the host time of its env draws,
peak memory, and a JSON line of those numbers. ``--profile DIR`` traces,
with utils/profiling.py ``profile_trace``, one untimed call of the eval
path users run, eval/rollout.py ``make_rollout_fn`` (its reset frame and
warm-up no-ops, without ``--skip_*``), on the same worlds, policy and ticks
after a warm-up call of its own, and prints the device's busy share, its
heaviest kernels, ``span_summary()`` of the call's ``rollout.*`` spans and
``idle_by_span`` of its trace. The loop above carries no spans.

Without a card it exits non-zero and prints no JSON unless ``--device
cpu`` is given; the CPU run takes the render's plain version and is for
tests, its rate the CPU's. Not ported: bench.py's backend watchdog, its
fallback from the Pallas kernel to the XLA render, and the TPU layout
probes ``GABRIL_RENDER_BLOCK``, ``GABRIL_BENCH_CONCAT_RING`` and
``GABRIL_PACK_CARRY``; the environment switches are the flags above.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .data.tasks import seen_routes, unseen_routes
from .env.env import DrivingEnv
from .env.world import build_world_spec, load_benchmark_specs, spec_rows, stack_specs, to_torch
from .eval.rollout import make_rollout_fn
from .ops.raster import render_frame
from .ops.render_kernel import H, W, render_kernel
from .train.bc import build_bc_models, init_bc_params, make_bc_policy_fn
from .utils.config import default_bc_config
from .utils.prng import env_draws, prng_key, split
from .utils.profiling import card_line, device_kernels, idle_by_span, profile_trace, span_summary

BASELINE = 20.0  # the reference's env steps/s per CARLA server (bench.py:4-6)
SKIP_POLICY_ACTION = (0.3, 0.0, 0.0)  # bench.py:171


def synthetic_routes(n_worlds: int) -> list[dict]:
    """bench.py:82-98's routes: 150-point sine curves of amplitude 30 *
    standard_normal() from ``np.random.default_rng(0)``, a
    PedestrianCrossing at waypoint 20, clear noon weather."""
    rng = np.random.default_rng(0)
    routes = []
    for i in range(n_worlds):
        t = np.linspace(0, 2 * np.pi, 150)
        curve = 30.0 * rng.standard_normal()
        wps = np.stack([300.0 * t / (2 * np.pi), curve * np.sin(t)], 1).astype(np.float32)
        routes.append({"id": i, "town": "T", "waypoints": wps,
                       "scenarios": [{"type": "PedestrianCrossing",
                                      "trigger": (float(wps[20, 0]), float(wps[20, 1]), 0.0)}],
                       "weather": [0, 0, 0, 90]})
    return routes


def bench_worlds(n_worlds: int, synthetic: bool = False, device="cuda"):
    """The benchmark's WorldSpec on ``device``: the 20 real routes (seen,
    then unseen) tiled to ``n_worlds``, or the synthetic routes."""
    if synthetic:
        specs = stack_specs([build_world_spec(r) for r in synthetic_routes(n_worlds)])
    else:
        ids = seen_routes() + unseen_routes()
        specs = spec_rows(load_benchmark_specs(ids), np.arange(n_worlds) % len(ids))
    return to_torch(specs, device)


def make_bench_run(policy_fn, cfg, n_steps: int, skip_policy: bool = False,
                   skip_render: bool = False):
    """run(spec, params, keys) -> the final ego positions [B, 2] after
    ``n_steps`` ticks; ``keys`` [B, 2] uint32 are the worlds' threefry keys.

    ``skip_render``: the frame is each world's ``sum(ego.pos) * 1e-6``
    everywhere and the render kernel does not launch. ``skip_policy``: the
    action is ``[0.3, 0, 0] + 1e-9 * obs[:, 0, 0, 0]`` (a 3-vector; the
    env decodes throttle, steer, brake)."""
    s = cfg.data["frame_stack"]
    fdt = torch.bfloat16 if cfg.training["compute_dtype"] == "bfloat16" else torch.float32
    env = DrivingEnv()

    @torch.inference_mode()
    def run(spec, params, keys):
        b = spec.route_len.shape[0]
        dev = spec.route_len.device
        keys = np.asarray(keys, np.uint32)
        if keys.shape != (b, 2):
            raise ValueError(f"keys must be [{b}, 2] threefry keys, got {keys.shape}")
        draws = torch.from_numpy(env_draws(keys, n_steps)).to(dev)
        const = torch.tensor(SKIP_POLICY_ACTION, device=dev)
        state = env.reset(spec)
        ring = [torch.zeros((b, H, W), dtype=fdt, device=dev) for _ in range(s)]
        for t in range(n_steps):
            if skip_render:
                frame = (state.ego.pos.sum(-1) * 1e-6).to(fdt)[:, None, None].expand(b, H, W)
            else:
                frame = render_frame(spec, state).to(fdt)
            ring = ring[1:] + [frame]
            obs = torch.stack(ring, -1)  # [B, H, W, S]
            if skip_policy:
                action = const + 1e-9 * obs[:, 0, 0, 0, None]
            else:
                action = policy_fn(params, obs)
            state = env.step(spec, state, action, draws[t])
        return state.ego.pos

    return run


def _log(msg: str):
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m gabril_carla_tpu_torch.bench",
                                description="rendered closed-loop env steps/s on one card")
    p.add_argument("n_worlds", type=int, nargs="?", default=1024)
    p.add_argument("n_steps", type=int, nargs="?", default=400)
    p.add_argument("--synthetic", action="store_true", help="bench.py's synthetic sine routes")
    p.add_argument("--skip_policy", action="store_true", help="constant action: render + env step")
    p.add_argument("--skip_render", action="store_true", help="state-seeded fill frame: policy + env step")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="trace one more untimed run into DIR and print its heaviest kernels")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        _log("no CUDA device (--device cpu runs the plain render on the CPU)")
        return 1
    dev = torch.device(args.device)
    n, steps = args.n_worlds, args.n_steps
    if cuda:
        _log(card_line())

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = default_bc_config()
    cfg["gaze"]["method"] = "None"
    cfg["training"]["compute_dtype"] = "bfloat16"
    models = build_bc_models(cfg, dev)
    params = init_bc_params(models, cfg, prng_key(0))
    policy = make_bc_policy_fn(models, cfg)
    spec = bench_worlds(n, args.synthetic, dev)
    keys = split(prng_key(0), n)
    run = make_bench_run(policy, cfg, steps, args.skip_policy, args.skip_render)

    run(spec, params, keys)  # warm-up
    sync()
    stats = {"worlds": n, "steps": steps, "device": torch.cuda.get_device_name(0) if cuda else "cpu"}
    if args.profile:
        rollout = make_rollout_fn(policy, cfg, steps)
        rollout(spec, params, keys)  # warm-up
        sync()
        with profile_trace(args.profile) as prof:
            t0 = time.perf_counter()
            rollout(spec, params, keys)
            sync()
            span = (time.perf_counter() - t0) * 1e3
        kernels = device_kernels(prof)
        busy = sum(ms for _, ms in kernels.values())
        stats["profile"] = {"busy_ms": busy, "wall_ms": span,
                            "launches": sum(c for c, _ in kernels.values())}
        _log(f"profiled eval rollout: device busy {busy:.3f} ms of {span:.3f} ms wall ({100 * busy / span:.1f}%), "
             f"{stats['profile']['launches']} kernel launches; trace in {args.profile}")
        for name, (c, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]:
            _log(f"{ms:10.3f} ms {c:7d}x {name[:100]}")
        summary = span_summary()
        stats["profile"].update(spans=summary["spans"], idle_by_span=idle_by_span(prof.trace_path))
        for name, sp in summary["spans"].items():
            _log(f"span {name}: {sp['count']}x, host {sp['host_ms']:.3f} ms (self {sp['host_self_ms']:.3f}), "
                 + ("stream not recorded" if sp["stream_ms"] is None else
                    f"stream {sp['stream_ms']:.3f} ms (self {sp['stream_self_ms']:.3f})"))
        for name, ms in stats["profile"]["idle_by_span"].items():
            _log(f"device idle {ms:10.3f} ms in {name}")

    if cuda:
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    render_kernel.launches = 0
    t0 = time.perf_counter()
    pos = run(spec, params, keys)
    if cuda:
        end.record()
    sync()
    dt = time.perf_counter() - t0
    launches = render_kernel.launches
    t_draws = time.perf_counter()
    env_draws(keys, steps)
    draws_s = time.perf_counter() - t_draws
    stats.update(wall_s=dt, render_launches=launches, env_draws_s=draws_s)
    if cuda:
        stats.update(event_s=start.elapsed_time(end) / 1e3,
                     peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        _log(f"timed run {dt:.4f} s on the host clock, {stats['event_s']:.4f} s between CUDA events; "
             f"peak memory {stats['peak_mem_gib']:.2f} GiB")
    _log(f"render kernel launches in the timed run: {launches}; env_draws for {n} worlds x {steps} "
         f"ticks {draws_s:.4f} s on the host ({100 * draws_s / dt:.2f}% of the run)")
    print(json.dumps({"bench_stats": stats}), file=sys.stderr, flush=True)
    want = 0 if args.skip_render or not cuda else steps
    if launches != want:
        _log(f"the render kernel launched {launches} times, want {want}")
        return 1
    if pos.shape != (n, 2) or not bool(torch.isfinite(pos).all()):
        _log("the run ended with non-finite or misshapen ego positions")
        return 1

    rate = n * steps / dt
    mode = (("synthetic" if args.synthetic else "real_routes")
            + ("+skip_policy" if args.skip_policy else "") + ("+skip_render" if args.skip_render else ""))
    print(json.dumps({"metric": "rendered_env_steps_per_sec_per_chip", "value": round(rate, 1),
                      "unit": "steps/s", "vs_baseline": round(rate / BASELINE, 1), "mode": mode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
