"""Smoke run of the PyTorch/CUDA port (gabril_carla_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit;
  2. build: nvcc compiles csrc/render.cu for sm_90a (registers, shared memory);
  3. kernel vs plain: the render kernel against its plain PyTorch version on
     the same operands, on the 20 real routes at reset and after 40 ticks,
     a crossing-flow scene and a tight-loop route. Bar (tests/test_raster.py):
     in every frame fewer than 1% of pixels off by more than 1e-3 and a
     median difference below 1e-5;
  4. main path: make_rollout_fn on the 20 real routes tiled to 256 worlds,
     full-width bf16 policy from a seeded generator, 100 ticks (warm-up
     included), timed after a warm-up run; the kernel must launch exactly
     ticks + 1 times in it; scores must be finite;
  5. the kernel at the main path's batch (its final state): held against
     the plain version at the same bar, then timed with CUDA events beside
     the plain version and the kernel's bound;
  6. where a tick's time goes: each stage's wall time, and a profiler
     window's device busy share and heaviest kernels.
Prints a JSON line of kernel records, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero without them when there is no
CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

N_WORLDS = 256
TICKS = 100
COMPARE_TICKS = 40
CHUNK = 8  # worlds per plain-version call (its [B, 87, 320, 160] distance tensor)
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM f32 outside the tensor cores
BAR_FRAC, BAR_MEDIAN = 0.01, 1e-5


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def compare(name, kernel_out, plain_out):
    """Worst per-frame share of pixels off by > 1e-3 and worst per-frame
    median difference; fails on the test_raster bar."""
    d = (kernel_out - plain_out).abs().flatten(1)
    frac = (d > 1e-3).float().mean(1).max().item()
    med = d.median(1).values.max().item()
    mx = d.max().item()
    log(f"[compare] {name}: {d.shape[0]} frames, worst off-share {frac:.6f}, "
        f"worst median {med:.3g}, max abs {mx:.4g}")
    if not (frac < BAR_FRAC and med < BAR_MEDIAN and torch.isfinite(kernel_out).all()):
        raise SystemExit(f"chip_smoke: render kernel disagrees with its plain version on {name}")
    return mx


def operands(spec, state):
    from gabril_carla_tpu_torch.ops import raster as R

    cam, fwd, right = R._camera_basis(state.ego.pos, state.ego.yaw)
    boxes = torch.cat([R._collect_actor_boxes(state, cam, fwd, right),
                       R._signal_boxes(spec, state, cam, fwd, right)], 1)
    return R._pallas_inputs(spec, state, cam, fwd, right, boxes, R.weather_now(spec, state))


def plain_chunked(ops):
    from gabril_carla_tpu_torch.ops.render_kernel import render_from_operands_plain

    return torch.cat([render_from_operands_plain(*(o[i:i + CHUNK] for o in ops))
                      for i in range(0, ops[0].shape[0], CHUNK)])


def kernel_vs_plain(name, ops):
    from gabril_carla_tpu_torch.ops.render_kernel import render_from_operands

    out = render_from_operands(*ops)  # checks the operands, launches the kernel
    torch.cuda.synchronize()
    return compare(name, out, plain_chunked(ops))


def single_route(route, state_edit, dev):
    from gabril_carla_tpu_torch.env.env import DrivingEnv
    from gabril_carla_tpu_torch.env.world import build_world_spec, stack_specs, to_torch

    spec = to_torch(stack_specs([build_world_spec(route)]), dev)
    state = DrivingEnv().reset(spec)
    return spec, state_edit(state)


def bound(ops):
    """Least time for the kernel's work on these operands: bytes (each input
    read once, the frames written once) over the memory rate, or the argmin
    and composite operations these inputs need over the f32 rate (ground
    pixels x valid rows x 5: two multiplies, two adds, a compare; pixels x
    valid boxes x 5 compares). Shading is not counted, so this stays a
    lower bound."""
    from gabril_carla_tpu_torch.ops import render_kernel as K

    cam, rows, boxes = ops
    v = torch.arange(K.H, dtype=torch.float32)
    z = (torch.tensor(K.CAM_Z * K.FX) / (v - K.CY).clamp_min(1e-3)).clamp(0.0, K.MAX_DEPTH)
    ground_px = int((((v - K.CY) > 0.5) & (z < K.MAX_DEPTH)).sum()) * K.W
    valid_rows = (rows[..., 2] < 1e11).sum().item()
    valid_boxes = (boxes[..., 6] > 0.5).sum().item()
    ops_n = 5.0 * ground_px * valid_rows + 5.0 * K.H * K.W * valid_boxes
    bytes_n = 4.0 * (cam.numel() + rows.numel() + boxes.numel() + cam.shape[0] * K.H * K.W)
    t_ops, t_bytes = ops_n / PEAK_F32_S * 1e3, bytes_n / PEAK_BYTES_S * 1e3
    log(f"[bound] {ops_n / 1e9:.4f} G operations over {PEAK_F32_S / 1e12:.0f} T/s = {t_ops:.4f} ms; "
        f"{bytes_n / 1e6:.2f} MB over {PEAK_BYTES_S / 1e12:.2f} TB/s = {t_bytes:.4f} ms")
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def breakdown(spec, params, policy, cfg, ticks=10):
    """Where a tick's time goes at the main path's batch: the wall time of
    each stage, synchronised around it, then a profiler window over a short
    rollout: the device's busy share and the kernels that fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gabril_carla_tpu_torch.env.env import DRAWS_PER_STEP, DrivingEnv
    from gabril_carla_tpu_torch.eval.rollout import make_rollout_fn
    from gabril_carla_tpu_torch.ops.raster import render_frame

    env = DrivingEnv()
    b = spec.route_len.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(4)
    draws = torch.rand((ticks, b, DRAWS_PER_STEP), generator=gen, device="cuda")
    wall = {"render": 0.0, "policy": 0.0, "env step": 0.0}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] += (time.perf_counter() - t0) * 1e3 / ticks
        return out

    with torch.inference_mode():
        state = env.reset(spec)
        frames = render_frame(spec, state)[..., None].repeat(1, 1, 1, cfg.data["frame_stack"])
        for t in range(ticks):
            frame = timed("render", lambda: render_frame(spec, state))
            frames = torch.cat([frames[..., 1:], frame[..., None]], -1)
            action = timed("policy", lambda: policy(params, frames))
            state = timed("env step", lambda: env.step(spec, state, action, draws[t]))
    log("[breakdown] wall ms per tick, each stage synchronised: "
        + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()))

    rollout = make_rollout_fn(policy, cfg, steps=ticks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(spec, params, draws=draws)
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in kernels.values()) / 1e3
    log(f"[breakdown] profiled {ticks} ticks: device busy {busy:.3f} ms of {span:.3f} ms wall "
        f"({100 * busy / span:.1f}%), {sum(n for n, _ in kernels.values())} kernel launches")
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[breakdown] {us / 1e3:10.3f} ms {n:6d}x {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    import numpy as np

    from gabril_carla_tpu_torch.data.tasks import seen_routes, unseen_routes
    from gabril_carla_tpu_torch.env.criteria import compute_score
    from gabril_carla_tpu_torch.env.world import load_benchmark_specs, to_torch
    from gabril_carla_tpu_torch.eval.rollout import make_rollout_fn
    from gabril_carla_tpu_torch.ops.render_kernel import build, render_kernel
    from gabril_carla_tpu_torch.train.bc import build_bc_models, init_bc_params, make_bc_policy_fn
    from gabril_carla_tpu_torch.utils.config import default_bc_config

    dev = "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind}; {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib, build_log = build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    render_kernel.load()

    # the policy and the worlds of the main path
    cfg = default_bc_config()
    cfg["gaze"]["method"] = "None"
    cfg["training"]["compute_dtype"] = "bfloat16"
    models = build_bc_models(cfg, dev)
    params = init_bc_params(models, cfg, torch.Generator(device=dev).manual_seed(0))
    policy = make_bc_policy_fn(models, cfg)
    ids = seen_routes() + unseen_routes()
    base = load_benchmark_specs(ids)

    # 3. kernel vs plain
    spec20 = to_torch(base, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    state40, _ = make_rollout_fn(policy, cfg, steps=COMPARE_TICKS)(spec20, params, gen)
    from gabril_carla_tpu_torch.env.env import DrivingEnv

    max_err = max(
        kernel_vs_plain("20 real routes at reset", operands(spec20, DrivingEnv().reset(spec20))),
        kernel_vs_plain(f"20 real routes after {COMPARE_TICKS} ticks", operands(spec20, state40)),
        kernel_vs_plain("crossing-flow scene", operands(*single_route(*_crossing_scene(), dev))),
        kernel_vs_plain("tight-loop route", operands(*single_route(*_tight_loop(), dev))),
    )

    # 4. main path at full width
    reps = -(-N_WORLDS // len(ids))
    tiled = type(base)(**{k: np.concatenate([v] * reps)[:N_WORLDS] for k, v in vars(base).items()})
    spec = to_torch(tiled, dev)
    m = cfg.model
    log(f"[main] policy: embedding {m['embedding_dim']}, hiddens {m['num_hiddens']}, "
        f"{m['num_residual_layers']} residual layers of {m['num_residual_hiddens']}, "
        f"z_dim {m['z_dim']}, frame stack {cfg.data['frame_stack']}, 180x320, bfloat16")
    rollout = make_rollout_fn(policy, cfg, steps=TICKS)
    rollout(spec, params, torch.Generator(device=dev).manual_seed(2))  # warm-up run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(3)
    render_kernel.launches = 0
    t0 = time.perf_counter()
    state, trace = rollout(spec, params, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = render_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] {N_WORLDS} worlds x {TICKS} ticks in {dt:.3f} s: "
        f"{N_WORLDS * TICKS / dt:.1f} env steps/s on {card}")
    log(f"[main] render launches {launches} (want {TICKS + 1}); peak memory {peak / 2**30:.2f} GiB")
    score = compute_score(spec, state)
    sc = score["score_composed"]
    log(f"[main] score_composed mean {sc.mean().item():.4f}, route % mean "
        f"{score['score_route'].mean().item():.4f}, done {int(state.done.sum())}")
    if launches != TICKS + 1:
        raise SystemExit(f"chip_smoke: the render kernel launched {launches} times, want {TICKS + 1}")
    if sc.shape != (N_WORLDS,) or not torch.isfinite(sc).all() or trace.shape != (TICKS, N_WORLDS, 2) \
            or not torch.isfinite(trace).all():
        raise SystemExit("chip_smoke: the rollout gave non-finite or misshapen results")

    # 5. kernel against its plain version, and its time, at the main path's batch
    ops = operands(spec, state)
    max_err = max(max_err, kernel_vs_plain(f"the main path's {N_WORLDS} worlds after {TICKS} ticks", ops))
    k_ms = time_ms(lambda: render_kernel(*ops), 50)
    p_ms = time_ms(lambda: plain_chunked(ops), 2)
    b_ms, b_by = bound(ops)
    log(f"[time] render kernel at {N_WORLDS} worlds: {k_ms:.4f} ms; plain version {p_ms:.3f} ms; "
        f"bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / k_ms:.1f}% of the bound); on {card}")
    log("[time] no single PyTorch call computes this function: library_ms is null")

    # 6. where the time goes
    breakdown(spec, params, policy, cfg)
    log(f"[done] {time.perf_counter() - t_all:.1f} s in all")

    print(json.dumps({"kernels": [{
        "name": "render", "route": "cuda", "source": "gabril_carla_tpu_torch/csrc/render.cu",
        "replaces": "gabril_carla_tpu/ops/pallas_raster.py:88", "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _crossing_scene():
    """Straight route with a perpendicular bicycle flow crossing at x=60,
    the ego 30 m short of it (tests/test_raster.py: crossing_scene)."""
    import numpy as np

    wps = np.stack([np.arange(0.0, 160, 2.0), np.zeros(80)], 1).astype(np.float32)
    route = {"id": 2, "town": "T", "waypoints": wps, "weather": [0, 0, 0, 90],
             "scenarios": [{"type": "CrossingBicycleFlow", "trigger": (40.0, 0.0, 0.0),
                            "start_actor_flow": (60.0, -40.0), "end_actor_flow": (60.0, 40.0),
                            "flow_speed": 8.0, "source_dist_interval": (12.0, 25.0)}]}

    def at(st):
        return st.replace(ego=st.ego.replace(pos=torch.tensor([[30.0, 0.0]], device=st.t.device),
                                             route_idx=torch.full_like(st.ego.route_idx, 30)))
    return route, at


def _tight_loop():
    """A route curling around the ego inside 7 m (tests/test_raster.py:214)."""
    import numpy as np

    t = np.linspace(0, 6 * np.pi, 120)
    r = 7.0
    wps = np.stack([r * np.cos(t), r * np.sin(t)], 1).astype(np.float32)
    route = {"id": 9, "town": "T", "waypoints": wps, "scenarios": [], "weather": [0, 0, 0, 90]}

    def at(st):
        return st.replace(ego=st.ego.replace(pos=torch.tensor([[r, 0.0]], device=st.t.device),
                                             route_idx=torch.full_like(st.ego.route_idx, 40)))
    return route, at


if __name__ == "__main__":
    sys.exit(main())
