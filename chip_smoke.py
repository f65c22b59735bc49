"""Smoke run of the PyTorch/CUDA port (gabril_carla_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit;
  2. build: nvcc compiles csrc/render.cu, csrc/threefry.cu and csrc/unet.cu for sm_90a, one
     process a source started together (registers, shared memory);
  3. kernel vs plain: the render kernel against its plain PyTorch version on
     the same operands, on the 20 real routes at reset and after 40 ticks
     (there under all four (far_decimate, lower_window) combinations), a
     crossing-flow scene, a tight-loop route and a crowded scene (more than
     24 visible boxes). Both visit the same rows and boxes, so the bar is
     near-exact: in every frame at most FLIP_PX pixels off by more than
     1e-5 (near ties of the argmin, which nvcc's FMA contraction can flip);
  4. main path: make_rollout_fn on the 20 real routes tiled to 256 worlds,
     full-width bf16 policy initialized from prng_key(0), 100 ticks (warm-up
     included), each world's env draws JAX's for its key of
     split(prng_key(3), 256), drawn on the host inside the run, timed after
     a warm-up run, with those draws' host time and share of the run beside
     it; the kernel must launch exactly ticks + 1 times in it; scores must
     be finite;
  5. the kernel at the main path's batch (its final state): held against
     the plain version at the same bar, then timed with CUDA events beside
     the plain version and the kernel's bound (the work of these operands'
     row sets, and the full-loop count beside it);
  6. where a tick's time goes: a profiler window over 10 ticks, its
     device busy share and heaviest kernels, and each port span's stream
     ms a tick (utils/profiling.py span_summary);
  7. the BC train step at bench_train.py's configuration (batch 2000, Reg,
     bf16, full width), its batch resident on the card, measured by the
     entry point as a user runs it, ``python -m
     gabril_carla_tpu_torch.bench_train`` in a subprocess at its defaults
     (a warm-up step, then TRAIN_STEPS timed): samples/s, step ms, the
     FLOPs of a step (FlopCounterMode) and mfu_pct from its last line, fatal
     unless that line carries bench_train.py's exact keys, a finite positive
     value, mode "bs2000_bf16_Reg_<card>" and 0 < mfu_pct <= 100; then in
     process, PROBE_STEPS steps from the same state, fatal unless the loss
     and metrics are finite, loss_reg > 0 and every parameter group moved,
     a profiler window with each train span's stream ms a step, and the
     step under cudnn.benchmark;
  8. every gaze x dropout method on the card: loss and gradients at the CPU
     parity tests' configuration (24x48, hiddens 16, batch 4, float32,
     draws given) against the same code on the CPU, within LOSS_RTOL and
     GRAD_FRAC; then one bf16 step of each at full width, batch 16, finite;
  9. the Trainer: 2 device-resident epochs at full width, batch 64, into a
     temporary directory, ending with a finite loss, ep2 and params.json;
 10. the gaze-predictor train step (AutoEncoder, batch 256, bf16, full
     width, batch resident on the card): one warm-up step, then GAZE_STEPS
     timed with CUDA events; samples/s, step ms, FLOPs and their share of
     the bf16 peak, peak memory, a profiler window; fatal unless the loss is
     finite and every parameter group moved; then UNet steps, finite;
 11. heat rollouts on the main path's 256 worlds, HEAT_TICKS ticks each,
     the throttle's bias at THROTTLE_BIAS: Mask with a frozen AutoEncoder
     predictor, GMD with analytic gaze, and the confounded two-pass (gaze
     None); run once untimed (heat bounds recorded), once timed; steps/s,
     a profiler window over 10 ticks with each span's stream ms; fatal unless
     the render kernel launched ticks + 1 times, the heat lies in [0, 1],
     the scores are finite, the median world moved over MOVED_M and some
     world scored, and the kernel matches its plain version at the final
     state;
 12. the entry points end to end in a temporary directory: the gaze
     predictor and a Mask policy trained through the CLIs, eval_routes on
     the 20 real routes x 1 seed (one stats.json each, held to its pair,
     and aggregate.json; some pair must score), calc_scores reproducing the
     aggregate's mean, a resumed eval_routes with nothing left to do, and
     the pairs in reverse order writing the same records;
 13. card against CPU at the CPU tests' widths: the AutoEncoder's and the
     UNet's float32 forward and loss (LOSS_RTOL), their gradients
     (GRAD_FRAC) in float64, and the AutoEncoder's also in float32; the
     UNet's float32 gradients and how far input noise moves its float64
     ones are read (gaze_agrees says why); analytic gaze on the 20 routes
     after COMPARE_TICKS ticks (within 1e-4, apart from slots whose hazard
     scores tie within 1e-6 relative);
 14. collection: cli/collect.py's main on route COLLECT_ROUTE with the
     COLLECT_SEEDS as 8 worlds, COLLECT_TICKS ticks at 180x320; steps/s of
     the rollout, a stage split (render, analytic gaze, expert, env step)
     and a profiler window; fatal unless the render kernel launched once a
     tick, every episode's files and stats.json exist and name their pair,
     the median world moved over COLLECT_MOVED_M and every world scored,
     the kernel matches its plain version at the final state, and
     expert_action on the card matches the CPU on the collected states
     (brake equal, throttle and steer within EXPERT_TOL);
 15. the VQ-VAE train step at default_bc_config's widths (batch 256, bf16,
     512 codes, batch resident on the card): a warm-up step, then VQ_STEPS
     timed with CUDA events; samples/s, FLOPs and their share of the bf16
     peak, peak memory, a profiler window; then card against CPU at the CPU
     tests' widths: metrics (LOSS_RTOL), gradients (GRAD_FRAC), code indices
     (equal but where the two nearest distances tie within VQ_TIE_RTOL) and
     the revive with given draws;
 16. the pipeline on phase 14's episodes, read through the converter's
     coercions (the card's machine has no h5py): train_vqvae 2 epochs, Oreo
     train_bc on its checkpoint (the codebook adopted bitwise), and the
     resume check in a subprocess under deterministic algorithms: a 3-epoch
     run against a 2-epoch run resumed for a third, final params and
     optimizer state bitwise equal;
 17. the full protocol, cli/full_benchmark.py's main at reduced depth
     (PROTO_ARGS: 2 train seeds, collection and eval 200 ticks, 1 epoch)
     with the methods PROTO_METHODS (regularizer, the UNet predictor's heat,
     Oreo's VQ-VAE); then the same command again, and a confounded,
     misperceived-gaze call from the first one's cache. Fatal unless K1
     launched once a tick in the collection and ticks + 1 in every eval
     rollout, K1 matches its plain version at the collection's final state,
     every cell has a finite seen and unseen mean, the expert scored every
     world and the median world moved over COLLECT_MOVED_M, the cache
     reloads the collected arrays, the rerun trained nothing, and the
     confounded store carries the overlay exactly on its masks (the dot
     where brake > 0.8);
 18. the data tools: eval_routes --xosc on each vendored storyboard (the
     one that needs the OpenDRIVE map refused naming RoadPosition) and
     collect --xosc, K1 at one world held to its plain version on each and
     launched ticks + 1 and ticks times, each stats.json naming the
     storyboard's route; generate_pseudo_gaze from the screen boxes of every
     collected tick; build_confounded over CONFOUND_EPISODES of phase 14's
     episodes, the card's output bitwise the CPU's; eval_routes --video, an
     mp4 read back where cv2 imports, else an ImportError naming cv2;
 19. multi-GPU on torch.distributed: the card's machine has one card, so
     NCCL at world size 1 (a one-rank group through a file rendezvous): the
     all-reduced full-width BC step bitwise the plain step, the all-reduce's
     and both steps' times, and a profiler window over DIST_PROFILE_STEPS
     grouped steps with each train span's stream ms a step (train.allreduce
     among them); the sharded eval (rollout_routes with a mesh) on
     the 20 routes, DIST_TICKS ticks, its final states and trace bitwise
     those without a mesh from the same key, K1 launched ticks + 1 times and
     held to its plain version at the final state; dryrun_multichip(1,
     "cuda") with its four legs, the 180x320 bf16 one included; then
     dryrun_multichip(2, "cpu") (two gloo processes) in a subprocess, and
     env_draws' host time for DRAWS_SIZES, fatal above 5% of its stage;
 20. the host-batch path: an in-memory store of HOST_DEMOS x HOST_STEPS
     frames at 180x320x3 uint8; BCDataset.sample through the native gather
     (csrc/gather.cpp, built with g++) bitwise equal to the numpy loop at
     the episode edges and on HOST_BATCHES random batches of 2,000, each
     gather's median ms and a batch's copy to the card; then the BC Trainer
     at bench_train.py's configuration with training.device_data false, one
     epoch (2 steps) a run, two runs with each gather in turns: samples/s,
     StageTimer's data and step ms; then one more run in a profiler window,
     each span's stream ms a Trainer step (StageTimer's trainer.<stage>
     spans and the train step's);
     fatal unless the batches are equal and the losses finite;
 21. human driving and the tools: HumanLoop's core (start, tick, save) on
     route HUMAN_ROUTE from seed HUMAN_SEED, one world, the scripted
     HUMAN_KEYS through a KeyboardController with dummy gaze, then
     PROFILE_TICKS more inside profile_trace; each tick's wall ms beside the
     50 ms of JAX's 20 fps loop. Fatal unless K1 launched once a tick and
     the trace names render_kernel once a profiled tick, the four files
     hold one row a tick and stats.json names the pair, cli/collect's
     collect replaying the recorded actions with the seed's draws gives
     the recorded frames bitwise and the same record, K1 matches its plain
     version at the final state; then visualize.panels on the card against
     the CPU on one of phase 14's episodes (heat within VIZ_TOL, uint8
     panels within one level);
 22. JAX's training draws on the card (csrc/threefry.cu): the threefry
     kernel at one IGMD step's draws at bench_train.py's batch of 2000
     (36.0 M uniforms), Oreo's [2000, 512] mask and counters across 2**32,
     bitwise its plain version on the card, slices bitwise numpy's threefry;
     its time (median of THREEFRY_RUNS runs, CUDA events) beside its bound,
     the plain version's and torch.rand's of the same shapes; its launches
     in one BC step of each dropout method (LAUNCHES_PER_STEP); IGMD_STEPS
     BC steps at batch 2000 with IGMD (2 launches a step) and a full-width
     IGMD Trainer epoch; card Trainers against CPU Trainers of one seed at
     the CPU tests' widths for GMD, IGMD and Oreo (every step's draws
     bitwise, the loss within LOSS_RTOL);
 23. the rendered closed loop's entry point (bench_train's is phase 7's):
     ``python -m gabril_carla_tpu_torch.bench`` at its defaults (bench.py's
     loop, 1024 worlds x 400 ticks) in a subprocess, its last line with
     bench.py's exact keys, a finite positive value, mode "real_routes" and
     K1 launched once a tick of the timed run; bench's main in process at
     TAG_WORLDS x TAG_STEPS with --skip_policy and --skip_render (tagged
     modes, K1 0 launches in the last) and at BENCH_WORLDS x
     BENCH_PROFILE_STEPS with --profile (the eval rollout's busy share, its
     spans and the device's idle by span, printed by bench); then its
     loop in process at BENCH_WORLDS x SHARE_STEPS, the full run and both
     skip variants alternated SHARE_REPS times, the stage shares by
     subtraction from the median tick times (bench.py:118-124), each
     reported only where the spread of the runs' shares is smaller; the
     full loop at SMALL_WORLDS x SMALL_STEPS, median of SHARE_REPS runs;
     K1 held to its plain version on the final state of the last full run
     at BENCH_WORLDS and timed there beside its bound and the plain
     version;
 24. the frozen gaze UNet's forward as CUDA kernels (ops/unet_kernel.py,
     csrc/unet.cu) at UNET_WORLDS frame rings (the mask_unet eval cell's
     heat): LAUNCHES_PER_FORWARD launches a forward, two calls bitwise,
     within tests/test_torch_unet_kernel.py's bar of the plain version on
     the card (TF32 off), timed with CUDA events beside its byte bound
     (each layer's inputs read once, bf16 written once), the plain version
     and, as library_ms, the module's cuDNN forward that it replaces.
Prints JSON lines of the kernel records, the train step's, the gaze
predictor step's, the heat rollouts', the collection's, the VQ-VAE step's,
the pipeline's, the protocol's, the tools', phase 19's, 20's, 21's, 22's,
23's and 24's numbers, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero without them when there is no
CUDA device or any phase fails. ``--resume-check EPISODES VQ_PATH OUT`` runs
phase 16's subprocess.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import time

import torch

from gabril_carla_tpu_torch.bench_train import (BATCH as TRAIN_BATCH, ITERS as TRAIN_STEPS, PEAK_BF16,
                                                bench_batch, bench_train_cfg)
from gabril_carla_tpu_torch.utils.profiling import card_line, device_kernels

N_WORLDS = 256
TICKS = 100
COMPARE_TICKS = 40
CHUNK = 8  # worlds per plain-version call (its [B, 87, 320, 160] distance tensor)
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM f32 outside the tensor cores
BAR_ABS, FLIP_PX = 1e-5, 4
PEAK_BF16_S = PEAK_BF16["NVIDIA H100 80GB HBM3"]  # H100 SXM dense bf16
# bench_train.py's step counted from the shapes: the encoder's convs and the
# pre-actor are 1.80 GFLOP a sample forward, x3 for forward and backward
FLOPS_COUNTED = 1.80e9 * 3 * TRAIN_BATCH
PROBE_STEPS = 3  # phase 7: in-process steps before the moved-group check (the first has lr 0)
LOSS_RTOL, GRAD_FRAC = 1e-4, 1e-3  # phases 8 and 13: card against CPU
GAZE_BATCH, GAZE_STEPS = 256, 20  # phase 10: the gaze config's batch, timed steps
HEAT_TICKS = 50  # phase 11
EVAL_STEPS = 60  # phase 12
# phases 11 and 12: the untrained policies' throttle bias, raised so that
# the worlds drive (tests/test_torch_rollout_heat.py's nudge); a world has
# driven once it is MOVED_M from where it stood after the warm-up ticks
THROTTLE_BIAS, MOVED_M = 0.6, 1.0
# the UNet's conv biases whose output channels are each a GroupNorm group of
# their own (8 channels, 8 groups): the norm removes them, so their exact
# gradient is 0 and any computed one is rounding noise
UNET_NULL = ("e1.convs.0.bias", "e1.convs.1.bias", "d1.convs.0.bias", "d1.convs.1.bias")
GAZE_TIE_RTOL = 1e-6  # phase 13: hazard scores this close may swap slots
KINK_NOISE = (1e-9, 1e-6)  # phase 13: relative input noise, below and at float32's differences


def log(msg):
    print(msg, flush=True)


def off_pixels(kernel_out, plain_out):
    """Per frame, the pixels where the kernel and its plain version differ
    by more than BAR_ABS, and the max abs difference over all frames."""
    d = (kernel_out - plain_out).abs().flatten(1)
    return (d > BAR_ABS).sum(1), d.max().item()


def compare(name, kernel_out, plain_out):
    """Fails unless every frame has at most FLIP_PX pixels off by more than
    BAR_ABS. A box missing from a block's list, or a row missing from a
    pixel's set, would put many more pixels off in one frame."""
    off, mx = off_pixels(kernel_out, plain_out)
    worst = int(off.max())
    log(f"[compare] {name}: {off.shape[0]} frames, worst frame {worst} pixels off by > {BAR_ABS:g} "
        f"(bar {FLIP_PX}), {int(off.sum())} in all, max abs {mx:.4g}")
    if not (worst <= FLIP_PX and torch.isfinite(kernel_out).all()):
        raise SystemExit(f"chip_smoke: render kernel disagrees with its plain version on {name}")
    return mx


def operands(spec, state, far_decimate=False):
    from gabril_carla_tpu_torch.ops import raster as R

    cam, fwd, right = R._camera_basis(state.ego.pos, state.ego.yaw)
    boxes = torch.cat([R._collect_actor_boxes(state, cam, fwd, right),
                       R._signal_boxes(spec, state, cam, fwd, right)], 1)
    return R._pallas_inputs(spec, state, cam, fwd, right, boxes, R.weather_now(spec, state),
                            far_decimate=far_decimate)


def plain_chunked(ops, **flags):
    from gabril_carla_tpu_torch.ops.render_kernel import render_from_operands_plain

    return torch.cat([render_from_operands_plain(*(o[i:i + CHUNK] for o in ops), **flags)
                      for i in range(0, ops[0].shape[0], CHUNK)])


def kernel_vs_plain(name, ops, **flags):
    from gabril_carla_tpu_torch.ops.render_kernel import render_from_operands

    out = render_from_operands(*ops, **flags)  # checks the operands, launches the kernel
    torch.cuda.synchronize()
    return compare(name, out, plain_chunked(ops, **flags))


def single_route(route, state_edit, dev):
    from gabril_carla_tpu_torch.env.env import DrivingEnv
    from gabril_carla_tpu_torch.env.world import build_world_spec, stack_specs, to_torch

    spec = to_torch(stack_specs([build_world_spec(route)]), dev)
    state = DrivingEnv().reset(spec)
    return spec, state_edit(state)


def bound(ops):
    """Least time for the kernel's work on these operands (default flags):
    bytes (each input read once, the frames written once) over the memory
    rate, or the operations these inputs need over the f32 rate, whichever
    is larger. One operation is one f32 flop, an FMA counting as two,
    against the 67 TFLOP/s rate outside the tensor cores. The argmin costs
    5 per row a ground pixel visits (two FMAs and a compare), summed over
    each pixel's class set on these operands (render_kernel.row_sets); the
    composite 5 per pixel a visible box covers (four bound compares and a
    depth compare), each box's area clipped to the frame. Shading is not
    counted, so this stays a lower bound. The loop takes about 5 issue slots
    per visited row (two FFMAs, a compare, two selects) at a lane-instruction
    rate of about half that flop rate (132 SMs x 128 lanes x ~1.98 GHz), so
    about 50% of this bound is the practical ceiling.

    Returns (ms, bound_by, full-loop ms): the last counts every valid row
    for every ground pixel and every valid box for every pixel, the work of
    a kernel without row sets or box binning."""
    from gabril_carla_tpu_torch.ops import render_kernel as K

    cam, rows, boxes = ops
    dev = cam.device
    v = torch.arange(K.H, dtype=torch.float32, device=dev)
    z = (torch.tensor(K.CAM_Z * K.FX, device=dev) / (v - K.CY).clamp_min(1e-3)).clamp(0.0, K.MAX_DEPTH)
    ground = ((v - K.CY) > 0.5) & (z < K.MAX_DEPTH)  # [H]
    cls = K.pixel_classes(dev)
    px_per_class = torch.stack([((cls == c) & ground[:, None]).sum() for c in range(4)]).double()
    row_visits = (K.row_sets(cam, rows.shape[1]).sum(-1).double() * px_per_class).sum().item()
    shown = (torch.arange(boxes.shape[1], device=dev)[None] < cam[:, 15:16]) & (boxes[..., 6] > 0.5)
    n_u = (boxes[..., 1].clamp(max=K.W - 1).floor() - boxes[..., 0].clamp(min=0).ceil() + 1).clamp(min=0)
    n_v = (boxes[..., 3].clamp(max=K.H - 1).floor() - boxes[..., 2].clamp(min=0).ceil() + 1).clamp(min=0)
    box_px = (n_u.double() * n_v.double() * shown).sum().item()
    ops_n = 5.0 * row_visits + 5.0 * box_px
    ground_px = int(ground.sum()) * K.W
    valid_rows = (rows[..., 2] < 1e11).sum().item()
    valid_boxes = (boxes[..., 6] > 0.5).sum().item()
    full_n = 5.0 * ground_px * valid_rows + 5.0 * K.H * K.W * valid_boxes
    bytes_n = 4.0 * (cam.numel() + rows.numel() + boxes.numel() + cam.shape[0] * K.H * K.W)
    t_ops, t_full = ops_n / PEAK_F32_S * 1e3, full_n / PEAK_F32_S * 1e3
    t_bytes = bytes_n / PEAK_BYTES_S * 1e3
    log(f"[bound] {row_visits / 1e6:.2f} M row visits, {box_px / 1e6:.3f} M box pixels: "
        f"{ops_n / 1e9:.4f} G operations over {PEAK_F32_S / 1e12:.0f} T/s = {t_ops:.4f} ms; "
        f"{bytes_n / 1e6:.2f} MB over {PEAK_BYTES_S / 1e12:.2f} TB/s = {t_bytes:.4f} ms; "
        f"full-loop count {full_n / 1e9:.4f} G operations = {t_full:.4f} ms")
    t, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return t, by, max(t_full, t_bytes)


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


def tick_keys(b: int, seed: int = 4):
    """The worlds' threefry keys ``split(prng_key(seed), b)`` for the
    rollouts the phases run: one fixed key a phase."""
    from gabril_carla_tpu_torch.utils.prng import prng_key, split

    return split(prng_key(seed), b)


def synced(wall: dict, name: str, fn, ticks: int):
    """``fn`` synchronised around each call, its wall ms per tick added to
    ``wall[name]``."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        wall[name] += (time.perf_counter() - t0) * 1e3 / ticks
        return out
    return run


def span_stages(tag: str, unit: str = "rollout.tick") -> dict:
    """Stream ms a ``unit`` (a tick or a train step) of each span the last
    profile_window kept (utils/profiling.py span_summary: the card's stream
    time between each span's CUDA events), logged with the launch counters;
    the unit's own self time is what no stage span covers."""
    from gabril_carla_tpu_torch.utils.profiling import span_summary

    summary = span_summary()
    spans = summary["spans"]
    n = spans[unit]["count"]
    out = {name: sp["stream_ms"] / n for name, sp in spans.items()}
    out[f"{unit} self"] = spans[unit]["stream_self_ms"] / n
    log(f"[{tag}] stream ms a {unit} by span over {n}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.items()) + f"; counters {summary['counters']}")
    return out


def profile_window(tag, what, fn, top=8):
    """Run ``fn`` under torch.profiler; log the device's busy share of the
    wall time and the heaviest kernels; return (busy ms, wall ms). The
    spans ``fn`` opens make a fresh record (span_stages reads it)."""
    from torch.profiler import ProfilerActivity, profile

    from gabril_carla_tpu_torch.utils.profiling import reset_spans

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reset_spans()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(ms for _, ms in kernels.values())
    log(f"[{tag}] profiled {what}: device busy {busy:.3f} ms of {span:.3f} ms wall "
        f"({100 * busy / span:.1f}%), {sum(n for n, _ in kernels.values())} kernel launches")
    for name, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[{tag}] {ms:10.3f} ms {n:6d}x {name[:90]}")
    return busy, span


# --- BC training (phases 7-9) -------------------------------------------------


# the last lines of the measuring entry points (phases 7 and 23)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "mode"}  # bench.py:230-243
TRAIN_KEYS = BENCH_KEYS | {"mfu_pct", "flops_per_step", "step_ms"}  # bench_train.py:110-117


def run_entry(module: str, *args: str) -> tuple[dict, dict, float]:
    """``python -m gabril_carla_tpu_torch.<module> args`` in a subprocess:
    (its last stdout line, its bench_stats line from stderr or {}, wall s).
    Echoes its stderr; fatal unless it exits 0."""
    from pathlib import Path

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"gabril_carla_tpu_torch.{module}", *args],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    stats = {}
    for line in out.stderr.splitlines():
        if line.startswith('{"bench_stats"'):
            stats = json.loads(line)["bench_stats"]
        else:
            log(f"[bench] {line}")
    if out.returncode != 0 or not out.stdout.strip():
        raise SystemExit(f"chip_smoke: {module} {' '.join(args)} exited {out.returncode}")
    last = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"[bench] {module} {' '.join(args)} in {wall:.1f} s: {json.dumps(last)}")
    return last, stats, wall


def narrow_cfg(gaze: str, dropout: str):
    """The CPU parity tests' BC configuration (tests/test_torch_common.py:
    bc_cfgs): 24x48, hiddens 16, float32, saliency temperature 1."""
    from gabril_carla_tpu_torch.utils.config import default_bc_config

    cfg = default_bc_config()
    cfg["data"].update(img_height=24, img_width=48, frame_stack=2, action_dim=7, batch_size=4)
    cfg["model"].update(embedding_dim=8, num_hiddens=16, num_residual_layers=1,
                        num_residual_hiddens=8, z_dim=16)
    cfg["gaze"].update(method=gaze, max_points=3, mask_sigma=4.0, beta=1.0)
    cfg["dropout"].update(method=dropout, num_embeddings=16, oreo_num_mask=2)
    cfg["training"].update(compute_dtype="float32", epochs=1)
    cfg["scheduler"]["type"] = "none"
    return cfg


def card_vs_cpu(gaze: str, dropout: str):
    """Loss, metrics and gradients of one method at narrow_cfg on the card
    and on the CPU, same parameters, batch and draws. Returns (largest
    relative metric gap, largest gradient gap over its leaf's scale)."""
    import numpy as np

    from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes
    from gabril_carla_tpu_torch.train.bc import (build_bc_models, init_bc_params, loss_and_grads,
                                                 step_draws)

    from gabril_carla_tpu_torch.utils.prng import prng_key

    cfg = narrow_cfg(gaze, dropout)
    cpu = build_bc_models(cfg, "cpu")
    params = init_bc_params(cpu, cfg, prng_key(0))
    store = synthetic_episodes(n_demos=1, steps=8, img_hw=(24, 48), max_points=3)
    batch = next(BCDataset(store, 2).iter_batches(4, np.random.default_rng(0)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = step_draws(prng_key(1), cfg, 4, "cpu")
    to_card = lambda d: {k: [t.cuda() for t in v] if k == "igmd" else v.cuda() for k, v in d.items()}
    _, m_cpu, g_cpu = loss_and_grads(cpu, cfg, params, batch, draws)
    _, m_card, g_card = loss_and_grads(build_bc_models(cfg, "cuda"), cfg,
                                       {k: v.cuda() for k, v in params.items()}, to_card(batch),
                                       to_card(draws))

    def gap(a, b):
        d = float((a - b).abs().max())
        return d / float(b.abs().max()) if d else 0.0

    return (max(gap(m_card[k].cpu(), m_cpu[k]) for k in m_cpu),
            max(gap(g_card[k].cpu(), g_cpu[k]) for k in g_cpu))


def train_phase(card: str) -> dict:
    """Phase 7: the train step at bench_train.py's configuration, timed by
    the entry point, then probed in process."""
    from gabril_carla_tpu_torch.bench_train import KEY, bench_train_state
    from gabril_carla_tpu_torch.train.bc import make_bc_train_step

    torch.cuda.empty_cache()  # leave the card's memory to the subprocess
    line, _, wall = run_entry("bench_train")
    mfu = line.get("mfu_pct")
    if not (set(line) == TRAIN_KEYS and line["metric"] == "train_samples_per_sec_per_chip"
            and math.isfinite(line["value"]) and line["value"] > 0
            and line["mode"].startswith(f"bs{TRAIN_BATCH}_bf16_Reg_") and mfu is not None and 0 < mfu <= 100):
        raise SystemExit(f"chip_smoke: bench_train at its defaults gave {line}")
    step_ms, flops = line["step_ms"], line["flops_per_step"]
    log(f"[train] bench_train.py's step (batch {TRAIN_BATCH}, Reg, bf16, full width) through the entry "
        f"point: {TRAIN_STEPS} steps {step_ms:.2f} ms each, {line['value']:.1f} samples/s, mfu {mfu}%; "
        f"FLOPs per step {flops / 1e12:.3f} T (FlopCounterMode; counted from the shapes "
        f"{FLOPS_COUNTED / 1e12:.2f} T); {wall:.1f} s in all; on {card}")

    cfg = bench_train_cfg()
    models, state0 = bench_train_state(cfg, "cuda")
    step = make_bc_train_step(models, cfg)
    batch = bench_batch(cfg, TRAIN_BATCH, "cuda")
    gen = KEY  # Reg draws nothing; the step takes its key all the same
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = step(state0, batch, gen)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(PROBE_STEPS - 1):
        state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    vals = {k: float(v) for k, v in metrics.items()}
    groups = sorted({k.split(".")[0] for k in state.params})
    moved = {g: any(not torch.equal(state.params[k], state0.params[k])
                    for k in state.params if k.startswith(g + ".")) for g in groups}
    finite = all(math.isfinite(v) for v in vals.values()) and all(
        bool(torch.isfinite(v).all()) for v in state.params.values())
    log(f"[train] in process: first step {first_ms:.1f} ms; peak memory {peak / 2**30:.2f} GiB; metrics after "
        f"{state.step} steps: " + ", ".join(f"{k} {v:.5f}" for k, v in vals.items())
        + "; parameter groups moved: " + ", ".join(f"{g} {m}" for g, m in moved.items()))
    if not finite or vals["loss_reg"] <= 0 or not all(moved.values()):
        raise SystemExit("chip_smoke: the train step gave non-finite results, loss_reg <= 0 or "
                         "left a parameter group unchanged")

    busy, span = profile_window("train", "3 steps", lambda: [step(state, batch, gen) for _ in range(3)])
    stages = span_stages("train", "train.step")

    torch.backends.cudnn.benchmark = True
    try:
        step(state, batch, gen)  # cudnn picks its algorithms here and in time_ms's first call
        bench_ms = time_ms(lambda: step(state, batch, gen), 10)
    finally:
        torch.backends.cudnn.benchmark = False
    log(f"[train] with cudnn.benchmark on: {bench_ms:.3f} ms a step "
        f"({TRAIN_BATCH / bench_ms * 1e3:.1f} samples/s)")
    return {"bench_train": line, "bench_train_wall_s": wall, "samples_per_s": line["value"],
            "step_ms": step_ms, "first_step_ms": first_ms, "flops_per_step": flops,
            "flops_counted": FLOPS_COUNTED, "bf16_peak_share": mfu / 100, "peak_mem_gib": peak / 2**30,
            "device_busy_share": busy / span, "span_stream_ms": stages, "cudnn_benchmark_step_ms": bench_ms,
            "card": card}


def methods_phase():
    """Phase 8: every method on the card against the CPU, then one bf16
    full-width step of each."""
    import numpy as np

    from gabril_carla_tpu_torch.train.bc import (DROPOUT_METHODS, GAZE_METHODS, init_bc_state,
                                                 make_bc_train_step)
    from gabril_carla_tpu_torch.train.optim import build_optimizer
    from gabril_carla_tpu_torch.utils.prng import prng_key

    worst = [0.0, 0.0]
    for gaze in GAZE_METHODS:
        for dropout in DROPOUT_METHODS:
            loss_gap, grad_gap = card_vs_cpu(gaze, dropout)
            worst = [max(worst[0], loss_gap), max(worst[1], grad_gap)]
            if loss_gap > LOSS_RTOL or grad_gap > GRAD_FRAC:
                raise SystemExit(f"chip_smoke: {gaze}/{dropout} on the card disagrees with the CPU: "
                                 f"metrics {loss_gap:.3g} (bar {LOSS_RTOL:g}), gradients "
                                 f"{grad_gap:.3g} of scale (bar {GRAD_FRAC:g})")
    log(f"[methods] {len(GAZE_METHODS) * len(DROPOUT_METHODS)} gaze x dropout methods, card against "
        f"CPU at 24x48 float32: worst metric gap {worst[0]:.3g} relative (bar {LOSS_RTOL:g}), worst "
        f"gradient gap {worst[1]:.3g} of its leaf's scale (bar {GRAD_FRAC:g})")
    for gaze in GAZE_METHODS:
        for dropout in DROPOUT_METHODS:
            cfg = bench_train_cfg(16)
            cfg["gaze"]["method"], cfg["dropout"]["method"] = gaze, dropout
            tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=100)
            models, state = init_bc_state(cfg, prng_key(0), tx)
            new, metrics = make_bc_train_step(models, cfg)(state, bench_batch(cfg, 16, "cuda"), prng_key(1))
            vals = [float(v) for v in metrics.values()]
            if not (np.isfinite(vals).all() and all(bool(torch.isfinite(v).all()) for v in new.params.values())):
                raise SystemExit(f"chip_smoke: the bf16 step of {gaze}/{dropout} is not finite")
    log("[methods] one bf16 step of each at full width, batch 16: finite")


def trainer_phase():
    """Phase 9: Trainer(cfg, BCDataset(synthetic_episodes(...)), mode="bc")."""
    import tempfile
    from pathlib import Path

    from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes
    from gabril_carla_tpu_torch.train.loop import Trainer

    cfg = bench_train_cfg(64)
    cfg["training"].update(epochs=2, device_data=True)
    with tempfile.TemporaryDirectory() as tmp:
        cfg["logging"]["log_dir"] = tmp
        t0 = time.perf_counter()
        trainer = Trainer(cfg, BCDataset(synthetic_episodes(n_demos=4, steps=64), 2), mode="bc")
        last = trainer.train()
        dt = time.perf_counter() - t0
        ckpt = Path(trainer.logger.ckpt_dir)
        ok = (trainer.device_mode and math.isfinite(last["loss"]) and (ckpt / "ep2" / "params.pt").exists()
              and (ckpt / "params.json").exists())
    log(f"[trainer] 2 device-resident epochs of {trainer.steps_per_epoch} steps at batch 64 in "
        f"{dt:.1f} s (set-up included): loss {last['loss']:.5f}, ep2 and params.json written: {ok}")
    if not ok:
        raise SystemExit("chip_smoke: the Trainer did not end with a finite loss, ep2 and params.json")


# --- the gaze-heat eval path (phases 10-13) -----------------------------------


def tree_to(x, device):
    """A WorldSpec or SceneState (dataclasses of tensors) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(**{f.name: tree_to(getattr(x, f.name), device) for f in dataclasses.fields(x)})


def gaze_cfg(arch="autoencoder", batch_size=GAZE_BATCH, tiny=False):
    """default_gaze_config (full width, 180x320, frame stack 2, bf16), or
    the CPU tests' widths in float32 with ``tiny``."""
    from gabril_carla_tpu_torch.utils.config import default_gaze_config

    cfg = default_gaze_config()
    cfg["data"]["batch_size"] = batch_size
    cfg["model"]["arch"] = arch
    if tiny:
        cfg["model"].update(embedding_dim=4, num_hiddens=8, num_residual_layers=1, num_residual_hiddens=4)
        cfg["training"]["compute_dtype"] = "float32"
    return cfg


def gaze_phase(card: str) -> dict:
    """Phase 10: the gaze-predictor train step at the gaze config's batch."""
    from torch.utils.flop_counter import FlopCounterMode

    from gabril_carla_tpu_torch.train.gaze_predictor import init_gaze_state, make_gaze_train_step
    from gabril_carla_tpu_torch.train.optim import build_optimizer
    from gabril_carla_tpu_torch.utils.prng import prng_key

    out = {"card": card}
    for arch in ("autoencoder", "unet"):
        cfg = gaze_cfg(arch)
        tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=100)
        (model, hm), state0 = init_gaze_state(cfg, prng_key(0), tx)
        step = make_gaze_train_step(model, hm, cfg)
        batch = bench_batch(cfg, GAZE_BATCH, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state0, batch)  # warm-up
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        n = GAZE_STEPS if arch == "autoencoder" else 3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / n
        peak = torch.cuda.max_memory_allocated()
        loss = float(metrics["loss"])
        groups = sorted({k.split(".")[0] for k in state.params})
        moved = {g: any(not torch.equal(state.params[k], state0.params[k])
                        for k in state.params if k.startswith(g + ".")) for g in groups}
        finite = math.isfinite(loss) and all(bool(torch.isfinite(v).all()) for v in state.params.values())
        with FlopCounterMode(display=False) as counter:
            step(state, batch)
        flops = counter.get_total_flops()
        bound_ms = flops / PEAK_BF16_S * 1e3
        log(f"[gaze] {arch} step (batch {GAZE_BATCH}, bf16, full width): first step {first_ms:.1f} ms; "
            f"{n} steps {step_ms:.3f} ms each, {GAZE_BATCH / step_ms * 1e3:.1f} samples/s; FLOPs per "
            f"step {flops / 1e12:.4f} T (FlopCounterMode), {100 * bound_ms / step_ms:.1f}% of the "
            f"{PEAK_BF16_S / 1e12:.0f} TFLOP/s bf16 peak; peak memory {peak / 2**30:.2f} GiB; loss "
            f"{loss:.5f} after {state.step} steps; groups moved {moved}; on {card}")
        if not finite or (arch == "autoencoder" and not all(moved.values())):
            raise SystemExit(f"chip_smoke: the {arch} gaze step gave non-finite results or left a "
                             "parameter group unchanged")
        busy, span = profile_window(f"gaze {arch}", "3 steps",
                                    lambda: [step(state, batch) for _ in range(3)])
        out[arch] = {"samples_per_s": GAZE_BATCH / step_ms * 1e3, "step_ms": step_ms,
                     "first_step_ms": first_ms, "steps_timed": n, "flops_per_step": flops,
                     "bf16_peak_share": bound_ms / step_ms, "peak_mem_gib": peak / 2**30, "loss": loss,
                     "device_busy_share": busy / span}
    return out


def heat_cases(dev):
    """Phase 11's policies at full width, bf16, random weights from seed 0,
    the throttle's bias raised to THROTTLE_BIAS so that the worlds drive:
    name -> (cfg, models, params, make_rollout_fn keywords)."""
    from gabril_carla_tpu_torch.train.bc import build_bc_models, init_bc_params
    from gabril_carla_tpu_torch.train.gaze_predictor import (build_gaze_models, init_gaze_params,
                                                             make_gaze_predictor_apply)
    from gabril_carla_tpu_torch.utils.config import default_bc_config
    from gabril_carla_tpu_torch.utils.prng import prng_key

    cases = {}
    for name, gaze, dropout in (("mask_predictor", "Mask", "None"), ("gmd_analytic", "None", "GMD"),
                                ("confounded", "None", "None")):
        cfg = default_bc_config()
        cfg["gaze"]["method"], cfg["dropout"]["method"] = gaze, dropout
        cfg["training"]["compute_dtype"] = "bfloat16"
        models = build_bc_models(cfg, dev)
        params = init_bc_params(models, cfg, prng_key(0))
        params["actor.fc2.bias"][0] = THROTTLE_BIAS
        kw = {"gmd_analytic": dict(use_analytic_gaze=True),
              "confounded": dict(confounded=True)}.get(name, {})
        if name == "mask_predictor":
            gp, _ = build_gaze_models(gaze_cfg(), dev)
            gp_params = init_gaze_params(gp, gaze_cfg(), prng_key(5))
            params = {**params, "gaze_predictor": gp_params}
            kw = dict(gaze_predictor_apply=make_gaze_predictor_apply(gp))
        cases[name] = (cfg, models, params, kw)
    return cases


def heat_phase(spec, card: str) -> tuple[dict, float]:
    """Phase 11: the three heat rollouts on the main path's worlds."""
    from gabril_carla_tpu_torch.env.criteria import compute_score
    from gabril_carla_tpu_torch.eval.rollout import WARMUP_STEPS, make_rollout_fn
    from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
    from gabril_carla_tpu_torch.train.bc import make_bc_policy_fn

    out, max_err = {}, 0.0
    b = spec.route_len.shape[0]
    for name, (cfg, models, params, kw) in heat_cases("cuda").items():
        policy = make_bc_policy_fn(models, cfg)
        bounds = []

        def probe(p, obs, heat=None):
            if heat is not None:
                bounds.append(torch.stack([heat.amin().float(), heat.amax().float()]))
            return policy(p, obs, heat)

        make_rollout_fn(probe, cfg, steps=HEAT_TICKS, **kw)(spec, params, tick_keys(b, 2))
        rollout = make_rollout_fn(policy, cfg, steps=HEAT_TICKS, **kw)
        torch.cuda.synchronize()
        render_kernel.launches = 0
        t0 = time.perf_counter()
        state, trace = rollout(spec, params, tick_keys(b, 3))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = render_kernel.launches
        sc = compute_score(spec, state)["score_composed"]
        moved = (trace[-1] - trace[WARMUP_STEPS - 1]).norm(dim=-1)
        drove = float(moved.median()) > MOVED_M and bool((sc > 0).any())
        lo_hi = torch.stack(bounds).cpu() if bounds else None
        heat_ok = lo_hi is None or (float(lo_hi[:, 0].min()) >= 0.0 and float(lo_hi[:, 1].max()) <= 1.0)
        busy, span = profile_window(f"heat {name}", "10 ticks", lambda: make_rollout_fn(
            policy, cfg, steps=10, **kw)(spec, params, tick_keys(b)))
        stages = span_stages(f"heat {name}")
        log(f"[heat] {name}: {b} worlds x {HEAT_TICKS} ticks in {dt:.3f} s, {b * HEAT_TICKS / dt:.1f} env "
            f"steps/s; render launches {launches} (want {HEAT_TICKS + 1}); heat in "
            + ("[%.4g, %.4g]" % (float(lo_hi[:, 0].min()), float(lo_hi[:, 1].max())) if lo_hi is not None
               else "(no heat: gaze None)")
            + f"; moved median {float(moved.median()):.3f} m, max {float(moved.max()):.3f} m; "
            f"score_composed mean {sc.mean().item():.4f}, > 0 in {int((sc > 0).sum())} worlds; on {card}")
        if launches != HEAT_TICKS + 1 or not heat_ok or not torch.isfinite(sc).all() \
                or not torch.isfinite(trace).all() or not drove:
            raise SystemExit(f"chip_smoke: heat rollout {name}: {launches} render launches (want "
                             f"{HEAT_TICKS + 1}), heat out of [0, 1], non-finite scores, or the "
                             f"median world moved no more than {MOVED_M} m or no score is above 0")
        max_err = max(max_err, kernel_vs_plain(f"heat rollout {name} at its final state",
                                               operands(spec, state)))
        out[name] = {"steps_per_s": b * HEAT_TICKS / dt, "wall_s": dt, "launches": launches,
                     "score_mean": sc.mean().item(), "worlds_scored": int((sc > 0).sum()),
                     "moved_median_m": float(moved.median()), "span_stream_ms": stages, "ticks": HEAT_TICKS,
                     "device_busy_share": busy / span}
    return out, max_err


def entry_points_phase(ids, specs) -> int:
    """Phase 12: train the gaze predictor and a Mask policy through the CLIs,
    evaluate the 20 real routes x 1 seed, read the tree back. ``specs`` are
    the routes' compiled worlds (in ``ids``' order), each stats.json is held
    to its pair: route id, seed and route length, and a run of the pairs in
    reverse order must write the same records (all but the wall-clock
    duration_system): each world's draws and compute are its own, so a
    record that went to another pair would differ. The Mask policy learns the
    synthetic episodes' zero-mean actions, so its saved throttle bias is
    raised to THROTTLE_BIAS before the eval, and some world must score.
    Returns the render kernel's launches in the eval run."""
    import tempfile
    from pathlib import Path

    from gabril_carla_tpu_torch.cli import calc_scores, eval_routes, train_bc, train_gaze_predictor
    from gabril_carla_tpu_torch.data.tasks import TASK_TO_ROUTE
    from gabril_carla_tpu_torch.eval.stats import ROUND
    from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
    from gabril_carla_tpu_torch.train.checkpoint import restore_params, save_params

    with tempfile.TemporaryDirectory() as tmp:
        common = ["data.batch_size=64", "training.device_data=true", f"logging.log_dir={tmp}"]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_gaze_predictor.main(common + ["training.epochs=2", "data.task=Gaze"])
        gaze_ckpt = next(Path(tmp).glob("Gaze/*/checkpoints"))
        t_gaze = time.perf_counter() - t0
        with contextlib.redirect_stdout(buf):
            train_bc.main(common + ["training.epochs=1", "data.task=Bc", "gaze.method=Mask",
                                    f"gaze.predictor_path={gaze_ckpt}"])
        bc_ckpt = next(Path(tmp).glob("Bc/*/checkpoints"))
        t_bc = time.perf_counter() - t0 - t_gaze
        manifest = json.loads((gaze_ckpt / "params.json").read_text())
        sd = restore_params(bc_ckpt / "ep1")
        sd["actor.fc2.bias"][0] = THROTTLE_BIAS
        save_params(bc_ckpt, 1, sd)
        # the seen and unseen test routes in one batch
        pairs = [(r, 400) for r in ids]
        TASK_TO_ROUTE["Real20_"] = {"test": pairs}
        out = Path(tmp) / "eval"
        args = ["--checkpoint", str(bc_ckpt), "--task", "Real20_", "--steps", str(EVAL_STEPS),
                "--out", str(out)]
        render_kernel.launches = 0
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            eval_routes.main(args)
        t_eval = time.perf_counter() - t1
        launches = render_kernel.launches
        files = sorted(out.glob("route_*/seed_*/stats.json"))
        recs = {(r, s): json.loads(f.read_text()) for r, s in pairs
                if (f := out / f"route_{r}" / f"seed_{s}" / "stats.json").exists()}
        agg = json.loads((out / "aggregate.json").read_text())
        calc = io.StringIO()
        with contextlib.redirect_stdout(calc), contextlib.redirect_stderr(io.StringIO()):
            calc_scores.main(["--stats_dir", str(out)])
        again = io.StringIO()
        with contextlib.redirect_stdout(again):
            eval_routes.main(args)
        TASK_TO_ROUTE["Real20_"] = {"test": pairs[::-1]}
        rev = Path(tmp) / "eval_reversed"
        with contextlib.redirect_stdout(buf):
            eval_routes.main(args[:-1] + [str(rev)])
        TASK_TO_ROUTE.pop("Real20_")
        unequal = [(r, s) for r, s in pairs if (r, s) not in recs or without_wall(recs[r, s]) != without_wall(
            json.loads((rev / f"route_{r}" / f"seed_{s}" / "stats.json").read_text()))]
    calc_mean = json.loads(calc.getvalue())["mean"]
    mismatched = [(r, s) for i, (r, s) in enumerate(pairs) if (r, s) in recs and (
        recs[r, s]["route_id"] != f"RouteScenario_{r}" or recs[r, s]["seed"] != s
        or recs[r, s]["meta"]["route_length"] != round(float(specs.route_len[i]), ROUND))]
    routed = sorted(rec["scores"]["score_route"] for rec in recs.values())
    scored = sum(rec["scores"]["score_composed"] > 0 for rec in recs.values())
    log(f"[entry] gaze predictor 2 device-resident epochs at batch 64 in {t_gaze:.1f} s (manifest "
        f"model_type {manifest.get('model_type')!r}); Mask BC 1 epoch in {t_bc:.1f} s; eval_routes on "
        f"{len(ids)} routes x 1 seed, {EVAL_STEPS} steps, in {t_eval:.1f} s: {len(files)} stats.json, "
        f"aggregate mean {agg['mean']:.4f} over {agg['n']}, render launches {launches} (want "
        f"{EVAL_STEPS + 1}); calc_scores mean {calc_mean:.4f}; route % median "
        f"{routed[len(routed) // 2] if routed else float('nan'):.4f}, {scored} pairs scored > 0; pairs "
        f"whose stats.json names another route, seed or route length: {mismatched}; pairs whose record "
        f"differs in the reversed run: {unequal}; resumed call: "
        f"{again.getvalue().strip()!r}")
    # calc_scores reads the files in path order, eval_routes wrote them in
    # pair order: the means may differ in the summation's last bit
    ok = (len(files) == len(ids) and agg["n"] == len(ids) and len(recs) == len(pairs)
          and not mismatched and not unequal and scored > 0
          and abs(calc_mean - agg["mean"]) <= 1e-9 * max(1.0, abs(agg["mean"]))
          and "Nothing to do" in again.getvalue() and manifest.get("model_type") == "gaze_predictor"
          and launches == EVAL_STEPS + 1)
    if not ok:
        raise SystemExit("chip_smoke: the entry points did not write every stats.json and aggregate.json, "
                         "a stats.json belongs to another pair or differs in the reversed run, no pair "
                         "scored, calc_scores disagreed, "
                         f"the resumed call had work left, or K1 launched {launches} times (want "
                         f"{EVAL_STEPS + 1})")
    return launches


def without_wall(rec: dict) -> dict:
    """A stats.json record with its wall-clock duration_system fields dropped."""
    rec = json.loads(json.dumps(rec))
    for meta in (rec["meta"], rec["_checkpoint"]["global_record"]["meta"],
                 rec["_checkpoint"]["records"][0]["meta"]):
        meta.pop("duration_system")
    return rec


def gaze_card_vs_cpu(arch) -> dict:
    """Phase 13: the gaze predictor at the CPU tests' widths on the card and
    on the CPU, same parameters and batch. Gaps, each the largest difference
    over the CPU's largest magnitude (a gradient's per leaf, then the worst
    leaf, UNET_NULL left out):
      forward, loss: float32, card against CPU;
      grads32: float32 gradients (gaze_loss_and_grads), card against CPU;
      grads64: float64 gradients (model, parameters, input and target in
        float64), card against CPU;
      card32_64, cpu32_64: each float32 gradient against the CPU's float64;
      smooth, kink: how far the card's float64 gradients move when the input
        is scaled by 1 + KINK_NOISE[i] * N(0, 1)."""
    from torch.func import functional_call

    from gabril_carla_tpu_torch.train.gaze_predictor import (build_gaze_models, gaze_loss_and_grads,
                                                             init_gaze_params)

    from gabril_carla_tpu_torch.utils.prng import prng_key

    cfg = gaze_cfg(arch, 2, tiny=True)
    cpu, hm = build_gaze_models(cfg, "cpu")
    params = init_gaze_params(cpu, cfg, prng_key(0))
    batch = bench_batch(cfg, 2, "cpu")
    card, hm_card = build_gaze_models(cfg, "cuda")
    p_card = {k: v.cuda() for k, v in params.items()}
    b_card = {k: v.cuda() for k, v in batch.items()}
    obs, target, _ = hm.prepare_for_gaze_predictor(batch["obs_seq"], batch["gaze_seq"], 2, grayscale=True)
    with torch.no_grad():
        f_cpu = functional_call(cpu, params, (obs,))
        f_card = functional_call(card, p_card, (obs.cuda(),)).cpu()
    l_cpu, _, g_cpu = gaze_loss_and_grads(cpu, hm, cfg, params, batch)
    l_card, _, g_card = gaze_loss_and_grads(card, hm_card, cfg, p_card, b_card)

    def grads64(dev, noise=0.0):
        model, _ = build_gaze_models(cfg, dev)
        model = model.double()
        for mod in model.modules():
            if hasattr(mod, "dtype"):
                mod.dtype = torch.float64
        x = obs.double() * (1.0 + noise * torch.randn(obs.shape, dtype=torch.float64,
                                                       generator=torch.Generator().manual_seed(9)))
        live = {k: v.to(dev, torch.float64).requires_grad_() for k, v in params.items()}
        loss = torch.mean((functional_call(model, live, (x.to(dev),)) - target.to(dev, torch.float64)) ** 2)
        return dict(zip(live, torch.autograd.grad(loss, list(live.values()))))

    def gap(a, b):
        d = float((a.cpu().double() - b.cpu().double()).abs().max())
        return d / float(b.abs().max()) if d else 0.0

    def worst(a, b):
        return max(gap(a[k], b[k]) for k in b if k not in UNET_NULL)

    g64_cpu, g64_card = grads64("cpu"), grads64("cuda")
    return {"forward": gap(f_card, f_cpu), "loss": gap(l_card, l_cpu), "grads32": worst(g_card, g_cpu),
            "grads64": worst(g64_card, g64_cpu), "card32_64": worst(g_card, g64_cpu),
            "cpu32_64": worst(g_cpu, g64_cpu), "smooth": worst(grads64("cuda", KINK_NOISE[0]), g64_card),
            "kink": worst(grads64("cuda", KINK_NOISE[1]), g64_card)}


def gaze_agrees(arch, gaps: dict) -> bool:
    """Forward and loss within LOSS_RTOL in float32; gradients within
    GRAD_FRAC of the CPU's, the AutoEncoder's in float32 and float64, the
    UNet's in float64. The UNet's float32 gradients are read, not held:
    its max pools and relus at 11x20 and 22x40, where one position weighs
    about 1e-3 of a leaf's gradient, make the gradient jump when rounding
    moves an activation across a kink. ``smooth`` and ``kink`` read it: the
    float64 gradient follows input noise of 1e-9 linearly and jumps under
    1e-6, the size of the float32 forward's card-to-CPU gap (``forward``).
    So card and CPU agree in float32 only where they fall on the same side
    of every kink; in float64 both do."""
    grads = max(gaps["grads32"], gaps["grads64"]) if arch == "autoencoder" else gaps["grads64"]
    return gaps["forward"] <= LOSS_RTOL and gaps["loss"] <= LOSS_RTOL and grads <= GRAD_FRAC


def analytic_card_vs_cpu(spec, state, curv: bool):
    """Phase 13: analytic_gaze on the card against the CPU. Returns (slots
    off by more than 1e-4 whose hazard scores do not tie, tied slots, max
    difference over the untied ones)."""
    from gabril_carla_tpu_torch.ops import raster as R

    spec_c, state_c = tree_to(spec, "cpu"), tree_to(state, "cpu")
    got = R.analytic_gaze(spec, state, 5, curvature_anticipation=curv).cpu().reshape(-1, 5, 2)
    want = R.analytic_gaze(spec_c, state_c, 5, curvature_anticipation=curv).reshape(-1, 5, 2)
    _, _, score = R.actor_hazards(spec_c, state_c, *R._camera_basis(state_c.ego.pos, state_c.ego.yaw))
    top = torch.sort(score, 1, descending=True).values[:, :5]  # ranks 0..4 of the actor slots
    near = (top[:, :-1] - top[:, 1:]).abs() <= GAZE_TIE_RTOL * top[:, :-1].abs()
    near &= torch.isfinite(top[:, 1:])
    tied = torch.zeros(top.shape[0], 5, dtype=torch.bool)  # slot 0 is the road point
    tied[:, 1:] = near[:, :4] | torch.cat([torch.zeros_like(near[:, :1]), near[:, :3]], 1)
    off = ((got - want).abs() > 1e-4).any(-1) | ((got < 0) != (want < 0)).any(-1)
    untied = ~tied
    diff = (got - want).abs().amax(-1)
    return int((off & untied).sum()), int(tied.sum()), float(diff[untied].max())


def card_vs_cpu_phase(spec20, state40):
    """Phase 13."""
    for arch in ("autoencoder", "unet"):
        g = gaze_card_vs_cpu(arch)
        held = "float32 and float64" if arch == "autoencoder" else "float64"
        log(f"[card-cpu] {arch} at the CPU tests' widths: float32 forward {g['forward']:.3g}, loss "
            f"{g['loss']:.3g} (bar {LOSS_RTOL:g}); worst gradient gap of its leaf's scale, card against "
            f"CPU: float32 {g['grads32']:.3g}, float64 {g['grads64']:.3g} (bar {GRAD_FRAC:g} in {held}); "
            f"float32 against float64: card {g['card32_64']:.3g}, CPU {g['cpu32_64']:.3g}; the card's "
            f"float64 gradient moved by input noise of {KINK_NOISE[0]:g}: {g['smooth']:.3g}, of "
            f"{KINK_NOISE[1]:g}: {g['kink']:.3g}")
        if not gaze_agrees(arch, g):
            raise SystemExit(f"chip_smoke: the {arch} gaze predictor on the card disagrees with the CPU")
    for curv in (False, True):
        bad, tied, mx = analytic_card_vs_cpu(spec20, state40, curv)
        log(f"[card-cpu] analytic gaze (curvature_anticipation={curv}), 20 routes after {COMPARE_TICKS} "
            f"ticks: {bad} untied slots off by > 1e-4, {tied} slots in a tie within {GAZE_TIE_RTOL:g}; max "
            f"difference over untied slots {mx:.3g}")
        if bad:
            raise SystemExit("chip_smoke: analytic gaze on the card disagrees with the CPU")


# --- the offline data-to-policy path (phases 14-16) ---------------------------

COLLECT_ROUTE, COLLECT_SEEDS, COLLECT_TICKS = 3100, tuple(range(200, 208)), 400  # phase 14
COLLECT_MOVED_M = 20.0
EXPERT_TOL = 1e-5  # tests/test_torch_expert.py: ACT_TOL
SPLIT_TICKS = 40  # phase 14's stage split
VQ_BATCH, VQ_STEPS = 256, 20  # phase 15
VQ_TIE_RTOL = 1e-6  # phase 15: codes whose two nearest distances are this close may swap
REVIVE_TOL = 1e-5  # phase 15: revived rows carry encoder latents


def expert_card_vs_cpu(spec, states) -> tuple[int, float]:
    """expert_action on the card against the CPU on ``states`` (each a
    SceneState on the card): (worlds whose brake differs, largest throttle
    or steer gap)."""
    from gabril_carla_tpu_torch.env.expert import expert_action

    spec_c = tree_to(spec, "cpu")
    flips, gap = 0, 0.0
    for st in states:
        got = expert_action(spec, st).cpu()
        want = expert_action(spec_c, tree_to(st, "cpu"))
        flips += int((got[:, 2:] != want[:, 2:]).any(1).sum())
        gap = max(gap, float((got[:, :2] - want[:, :2]).abs().max()))
    return flips, gap


def collect_phase(card: str, out_dir) -> tuple[dict, int, float]:
    """Phase 14: cli/collect.py's main on COLLECT_ROUTE with the seeds as
    worlds. Returns (record, K1 launches in the run, K1's error against its
    plain version at the final state)."""
    from pathlib import Path
    from unittest import mock

    from gabril_carla_tpu_torch.cli import collect as CL
    from gabril_carla_tpu_torch.env.criteria import compute_score
    from gabril_carla_tpu_torch.env.env import DrivingEnv
    from gabril_carla_tpu_torch.ops.render_kernel import render_kernel

    seen, probes, ticks = {}, [], [0]
    collect_fn, expert_fn = CL.collect, CL.expert_action

    def run_collect(spec, steps, draws, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collect_fn(spec, steps, draws, *args, **kwargs)
        torch.cuda.synchronize()
        seen.update(spec=spec, state=out[0], rollout_s=time.perf_counter() - t0)
        return out

    def probe_expert(spec, state):
        if ticks[0] % 100 == 0:  # the collected states the card is held to the CPU on
            probes.append(state)
        ticks[0] += 1
        return expert_fn(spec, state)

    args = ["--route", str(COLLECT_ROUTE), "--steps", str(COLLECT_TICKS), "--out", str(out_dir),
            "--seeds", *map(str, COLLECT_SEEDS)]
    buf = io.StringIO()
    with mock.patch.multiple(CL, collect=run_collect, expert_action=probe_expert):
        torch.cuda.synchronize()
        render_kernel.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            CL.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = render_kernel.launches
    spec, state = seen["spec"], seen["state"]
    b = len(COLLECT_SEEDS)
    rate = b * COLLECT_TICKS / seen["rollout_s"]

    # where a tick's time goes, and the device's busy share
    split = dict.fromkeys(("render", "analytic gaze", "expert", "env step"), 0.0)

    class Env(DrivingEnv):
        step = synced(split, "env step", DrivingEnv.step, SPLIT_TICKS)

    draws = CL.seed_draws(COLLECT_SEEDS, SPLIT_TICKS, "cuda")
    with mock.patch.multiple(CL, DrivingEnv=Env,
                             render_frame=synced(split, "render", CL.render_frame, SPLIT_TICKS),
                             analytic_gaze=synced(split, "analytic gaze", CL.analytic_gaze, SPLIT_TICKS),
                             expert_action=synced(split, "expert", CL.expert_action, SPLIT_TICKS)):
        CL.collect(spec, SPLIT_TICKS, draws)
    n_prof = min(10, SPLIT_TICKS)
    busy, span = profile_window("collect", f"{n_prof} ticks", lambda: CL.collect(spec, n_prof, draws))

    err = kernel_vs_plain("collect's final state", operands(spec, state))
    flips, gap = expert_card_vs_cpu(spec, probes + [state])
    sc = compute_score(spec, state)["score_composed"].cpu()
    moved = (state.ego.pos - spec.spawn_pos).norm(dim=-1).cpu()
    missing = []
    for s in COLLECT_SEEDS:
        ep = Path(out_dir) / f"route_{COLLECT_ROUTE}" / f"seed_{s}"
        names = ("observations.npz", "actions.npz", "gaze.npz", "stats.json")
        if not all((ep / n).exists() for n in names):
            missing.append(s)
            continue
        rec = json.loads((ep / "stats.json").read_text())
        if rec["route_id"] != f"RouteScenario_{COLLECT_ROUTE}" or rec["seed"] != s:
            missing.append(s)
    log(f"[collect] collect.main on route {COLLECT_ROUTE}, {b} seeds as worlds x {COLLECT_TICKS} ticks "
        f"at 180x320: rollout {seen['rollout_s']:.3f} s, {rate:.1f} env steps/s; main {wall:.1f} s "
        f"with the episode files; render launches {launches} (want {COLLECT_TICKS}); ticks per world "
        f"{state.t.tolist()}; score_composed {[round(float(x), 2) for x in sc]}; moved median "
        f"{float(moved.median()):.1f} m; on {card}")
    log(f"[collect] wall ms per tick over {SPLIT_TICKS} ticks, each stage synchronised: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log(f"[collect] expert_action card against CPU on {len(probes) + 1} collected states: {flips} worlds "
        f"with another brake, largest throttle/steer gap {gap:.3g} (bar {EXPERT_TOL:g})")
    if (launches != COLLECT_TICKS or missing or float(moved.median()) <= COLLECT_MOVED_M
            or not bool((sc > 0).all()) or flips or gap > EXPERT_TOL):
        raise SystemExit(f"chip_smoke: collection: {launches} render launches (want {COLLECT_TICKS}), "
                         f"seeds without their files or stats.json {missing}, median world moved "
                         f"{float(moved.median()):.1f} m (want > {COLLECT_MOVED_M}), a world scored 0, "
                         f"or the expert on the card disagrees with the CPU")
    rec = {"steps_per_s": rate, "rollout_s": seen["rollout_s"], "main_s": wall, "launches": launches,
           "ticks": COLLECT_TICKS, "worlds": b, "stages_ms": split, "device_busy_share": busy / span,
           "score_composed": sc.tolist(), "moved_median_m": float(moved.median()),
           "expert_gap": gap, "card": card}
    return rec, launches, err


def vq_cfg(batch_size=VQ_BATCH, tiny=False):
    """default_bc_config's VQ-VAE (full width, 180x320, frame stack 2, 512
    codes, bf16), or the CPU tests' widths in float32 with ``tiny``."""
    from gabril_carla_tpu_torch.utils.config import default_bc_config

    cfg = default_bc_config()
    cfg["data"]["batch_size"] = batch_size
    cfg["training"]["compute_dtype"] = "bfloat16"
    if tiny:
        cfg["model"].update(embedding_dim=4, num_hiddens=8, num_residual_layers=1, num_residual_hiddens=4)
        cfg["dropout"]["num_embeddings"] = 16
        cfg["training"]["compute_dtype"] = "float32"
    return cfg


def vqvae_card_vs_cpu() -> dict:
    """The VQ-VAE at the CPU tests' widths on the card and on the CPU, same
    parameters and batch: metric and gradient gaps (as card_vs_cpu), code
    indices that differ where the two nearest distances do not tie, and the
    revive with given draws (dead count, kept rows bitwise, revived rows)."""
    from torch.func import functional_call

    from gabril_carla_tpu_torch.train import vqvae as V

    from gabril_carla_tpu_torch.utils.prng import prng_key

    cfg = vq_cfg(2, tiny=True)
    cpu = V.build_vqvae_models(cfg, "cpu")
    params = V.init_vqvae_params(cpu, cfg, prng_key(0))
    batch = bench_batch(cfg, 2, "cpu")
    card = V.build_vqvae_models(cfg, "cuda")
    p_card = {k: v.cuda() for k, v in params.items()}
    b_card = {k: v.cuda() for k, v in batch.items()}
    _, m_cpu, g_cpu = V.vqvae_loss_and_grads(cpu, cfg, params, batch)
    _, m_card, g_card = V.vqvae_loss_and_grads(card, cfg, p_card, b_card)

    def gap(a, b):
        d = float((a.cpu() - b).abs().max())
        return d / float(b.abs().max()) if d else 0.0

    def codes(model, p, x):
        enc = {k[8:]: v for k, v in p.items() if k.startswith("encoder.")}
        z = functional_call(model.encoder, enc, (x,)).float()
        flat = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1])
        cb = p["quantizer.codebook"] - 1.0 / cfg.dropout["num_embeddings"]
        dist = (flat**2).sum(1, keepdim=True) + (cb**2).sum(1)[None] - 2.0 * flat @ cb.T
        return dist.argmin(1).cpu(), dist.cpu()

    x = V.stacked_frames(cfg, batch["obs_seq"])
    i_cpu, d_cpu = codes(cpu, params, x)
    i_card, _ = codes(card, p_card, x.cuda())
    top2 = d_cpu.topk(2, dim=1, largest=False).values
    tie = (top2[:, 1] - top2[:, 0]).abs() <= VQ_TIE_RTOL * top2[:, 0].abs()
    off = i_cpu != i_card

    draws = V.revive_draws(prng_key(3), x.shape[0] * 20 * 38, 16, 4, "cpu")
    sd = dict(params)
    sd["quantizer.codebook"] = sd["quantizer.codebook"].clone()
    sd["quantizer.codebook"][:6] = 5.0  # six codes no latent maps to
    r_cpu, dead_cpu = V.make_revive_dead_codes(cpu, cfg)(sd, batch, draws)
    r_card, dead_card = V.make_revive_dead_codes(card, cfg)(
        {k: v.cuda() for k, v in sd.items()}, b_card, {k: v.cuda() for k, v in draws.items()})
    kept = (r_cpu["quantizer.codebook"] == sd["quantizer.codebook"]).all(1)
    cb_card = r_card["quantizer.codebook"].cpu()
    return {"metrics": max(gap(m_card[k], m_cpu[k]) for k in m_cpu),
            "grads": max(gap(g_card[k], g_cpu[k]) for k in g_cpu),
            "codes_off": int((off & ~tie).sum()), "codes_tied": int(tie.sum()), "codes": int(off.numel()),
            "dead": (int(dead_cpu), int(dead_card)),
            "kept_equal": bool(torch.equal(cb_card[kept], r_cpu["quantizer.codebook"][kept])),
            "revived_gap": float((cb_card[~kept] - r_cpu["quantizer.codebook"][~kept]).abs().max())}


def vqvae_agrees(g: dict) -> bool:
    return (g["metrics"] <= LOSS_RTOL and g["grads"] <= GRAD_FRAC and g["codes_off"] == 0
            and g["dead"][0] == g["dead"][1] >= 6 and g["kept_equal"] and g["revived_gap"] <= REVIVE_TOL)


def vqvae_phase(card: str) -> dict:
    """Phase 15: the VQ-VAE train step at default_bc_config's widths."""
    from torch.utils.flop_counter import FlopCounterMode

    from gabril_carla_tpu_torch.train.optim import build_optimizer
    from gabril_carla_tpu_torch.train.vqvae import init_vqvae_state, make_vqvae_train_step
    from gabril_carla_tpu_torch.utils.prng import prng_key

    cfg = vq_cfg()
    tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=100)
    model, state0 = init_vqvae_state(cfg, prng_key(0), tx)
    step = make_vqvae_train_step(model, cfg)
    batch = bench_batch(cfg, VQ_BATCH, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state0, batch)  # warm-up
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(VQ_STEPS):
        state, metrics = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / VQ_STEPS
    peak = torch.cuda.max_memory_allocated()
    vals = {k: float(v) for k, v in metrics.items()}
    groups = sorted({k.split(".")[0] for k in state.params})
    moved = {g: any(not torch.equal(state.params[k], state0.params[k])
                    for k in state.params if k.startswith(g + ".")) for g in groups}
    finite = all(math.isfinite(v) for v in vals.values()) and all(
        bool(torch.isfinite(v).all()) for v in state.params.values())
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    flops = counter.get_total_flops()
    bound_ms = flops / PEAK_BF16_S * 1e3
    m = cfg.model
    log(f"[vqvae] step (batch {VQ_BATCH}, bf16, 180x320, hiddens {m['num_hiddens']}, embedding "
        f"{m['embedding_dim']}, {cfg.dropout['num_embeddings']} codes): first step {first_ms:.1f} ms; "
        f"{VQ_STEPS} steps {step_ms:.3f} ms each, {VQ_BATCH / step_ms * 1e3:.1f} samples/s; FLOPs per "
        f"step {flops / 1e12:.4f} T (FlopCounterMode), {100 * bound_ms / step_ms:.1f}% of the "
        f"{PEAK_BF16_S / 1e12:.0f} TFLOP/s bf16 peak; peak memory {peak / 2**30:.2f} GiB; "
        + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()) + f"; groups moved {moved}; on {card}")
    if not finite or not all(moved.values()):
        raise SystemExit("chip_smoke: the VQ-VAE step gave non-finite results or left a parameter "
                         "group unchanged")
    busy, span = profile_window("vqvae", "3 steps", lambda: [step(state, batch) for _ in range(3)])
    g = vqvae_card_vs_cpu()
    log(f"[vqvae] card against CPU at the CPU tests' widths, float32: metrics {g['metrics']:.3g} "
        f"(bar {LOSS_RTOL:g}), gradients {g['grads']:.3g} of scale (bar {GRAD_FRAC:g}); code indices "
        f"off {g['codes_off']} of {g['codes']} outside ties ({g['codes_tied']} tied within "
        f"{VQ_TIE_RTOL:g}); revive with given draws: dead {g['dead']}, kept rows bitwise "
        f"{g['kept_equal']}, revived rows within {g['revived_gap']:.3g} (bar {REVIVE_TOL:g})")
    if not vqvae_agrees(g):
        raise SystemExit("chip_smoke: the VQ-VAE on the card disagrees with the CPU")
    return {"samples_per_s": VQ_BATCH / step_ms * 1e3, "step_ms": step_ms, "first_step_ms": first_ms,
            "flops_per_step": flops, "bf16_peak_share": bound_ms / step_ms, "peak_mem_gib": peak / 2**30,
            "device_busy_share": busy / span, "metrics": vals, "card_vs_cpu": g, "card": card}


PIPE_COMMON = ["data.batch_size=64", "training.device_data=true", "training.save_interval=1"]


def episode_dataset(root):
    """build_dataset for the CLIs: the collected episodes through the
    converter's coercions (the card's machine has no h5py for an HDF5)."""
    from gabril_carla_tpu_torch.data.converter import load_episodes
    from gabril_carla_tpu_torch.data.dataset import BCDataset

    store = load_episodes(root)
    return lambda cfg: BCDataset(store, frame_stack=cfg.data["frame_stack"])


def resume_check(episodes, vq_path, out) -> dict:
    """Oreo BC on the collected episodes through train_bc: 3 epochs in one
    run against 2 epochs resumed for a third (``--resume``); run in a
    subprocess under torch.use_deterministic_algorithms(True). Returns which
    final params and optimizer leaves differ."""
    from pathlib import Path
    from unittest import mock

    from gabril_carla_tpu_torch.cli import train_bc
    from gabril_carla_tpu_torch.train.checkpoint import latest_resume_state, load_resume_tree

    torch.use_deterministic_algorithms(True)
    args = PIPE_COMMON + [f"logging.log_dir={out}", "data.task=Resume", "dropout.method=Oreo",
                          f"dropout.vqvae_path={vq_path}", "training.resume_interval=1"]
    with mock.patch.object(train_bc, "build_dataset", episode_dataset(episodes)), \
            contextlib.redirect_stdout(io.StringIO()):
        train_bc.main(args + ["training.epochs=3", "logging.run_name=whole"])
        train_bc.main(args + ["training.epochs=2", "logging.run_name=cut"])
        train_bc.main(["--resume", str(Path(out) / "Resume" / "cut"), "training.epochs=3"] + args)
    trees = [load_resume_tree(latest_resume_state(Path(out) / "Resume" / r / "checkpoints")[0])
             for r in ("whole", "cut")]

    def unequal(a, b, name):
        if isinstance(a, torch.Tensor):
            return [] if torch.equal(a, b) else [name]
        if isinstance(a, dict):
            return [n for k in a for n in unequal(a[k], b[k], f"{name}.{k}")]
        return [] if a == b else [name]

    return {"params": unequal(trees[0]["params"], trees[1]["params"], "params"),
            "opt_state": unequal(trees[0]["opt_state"], trees[1]["opt_state"], "opt_state"),
            "step": (int(trees[0]["step"]), int(trees[1]["step"]))}


def run_resume_check(episodes, vq_path, out) -> dict:
    """resume_check in a fresh process (chip_smoke.py --resume-check) with
    cuBLAS's deterministic workspace; its last line is the JSON result."""
    import os

    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    proc = subprocess.run([sys.executable, __file__, "--resume-check", str(episodes), str(vq_path), str(out)],
                          capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: the resume check failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def pipeline_phase(card: str, episodes, tmp) -> dict:
    """Phase 16: train_vqvae 2 epochs and Oreo BC on it through the CLIs,
    on phase 14's episodes; then the resume check."""
    from pathlib import Path
    from unittest import mock

    from gabril_carla_tpu_torch.cli import train_bc, train_vqvae
    from gabril_carla_tpu_torch.train.checkpoint import load_manifest, restore_params

    common = PIPE_COMMON + [f"logging.log_dir={tmp}"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    dataset = episode_dataset(episodes)
    t_data = time.perf_counter() - t0
    with mock.patch.object(train_bc, "build_dataset", dataset), contextlib.redirect_stdout(buf):
        train_vqvae.main(common + ["training.epochs=2", "data.task=Vq"])
        t_vq = time.perf_counter() - t0 - t_data
        vq_ckpt = next(Path(tmp).glob("Vq/*/checkpoints"))
        train_bc.main(common + ["training.epochs=1", "data.task=Oreo", "dropout.method=Oreo",
                                f"dropout.vqvae_path={vq_ckpt / 'ep2'}"])
    t_bc = time.perf_counter() - t0 - t_data - t_vq
    bc_ckpt = next(Path(tmp).glob("Oreo/*/checkpoints"))
    vq, bc = restore_params(vq_ckpt / "ep2"), restore_params(bc_ckpt / "ep1")
    adopted = torch.equal(vq["quantizer.codebook"], bc["quantizer.codebook"])
    loaded = f"Loaded VQ-VAE from {vq_ckpt / 'ep2'}" in buf.getvalue()
    vq_metrics = [json.loads(x) for x in (vq_ckpt.parent / "metrics.jsonl").read_text().splitlines()]
    bc_metrics = [json.loads(x) for x in (bc_ckpt.parent / "metrics.jsonl").read_text().splitlines()]
    t1 = time.perf_counter()
    res = run_resume_check(episodes, vq_ckpt / "ep2", Path(tmp) / "resume")
    t_res = time.perf_counter() - t1
    n = sum(1 for _ in Path(episodes).glob("route_*/seed_*"))
    log(f"[pipeline] {n} episodes read through the converter's coercions in {t_data:.1f} s; train_vqvae "
        f"2 epochs in {t_vq:.1f} s (loss {vq_metrics[-1]['loss']:.5f}, perplexity "
        f"{vq_metrics[-1]['perplexity']:.2f}, dead codes revived {[int(r['dead_codes']) for r in vq_metrics]}, "
        f"manifest model_type {load_manifest(vq_ckpt / 'params.json').get('model_type')!r}); Oreo train_bc "
        f"1 epoch in {t_bc:.1f} s (loss {bc_metrics[-1]['loss']:.5f}), VQ-VAE loaded: {loaded}, codebook "
        f"bitwise the trained one: {adopted}; on {card}")
    log(f"[pipeline] resume check (3 epochs against 2 resumed for a third, deterministic algorithms) in "
        f"{t_res:.1f} s: unequal params {res['params']}, unequal optimizer state {res['opt_state']}, steps "
        f"{res['step']}")
    ok = (adopted and loaded and math.isfinite(vq_metrics[-1]["loss"]) and math.isfinite(bc_metrics[-1]["loss"])
          and load_manifest(vq_ckpt / "params.json").get("model_type") == "vqvae"
          and not res["params"] and not res["opt_state"] and res["step"][0] == res["step"][1])
    if not ok:
        raise SystemExit("chip_smoke: the pipeline: the VQ-VAE or Oreo BC did not train, Oreo did not adopt "
                         "the trained codebook bitwise, or the resumed run differs from the whole one")
    return {"vqvae_s": t_vq, "oreo_s": t_bc, "data_s": t_data, "resume_check_s": t_res,
            "vq_loss": vq_metrics[-1]["loss"], "oreo_loss": bc_metrics[-1]["loss"], "card": card}


# --- the full protocol and the data tools (phases 17-18) ----------------------

PROTO_ARGS = ["--train_seeds", "200", "201", "--eval_seeds", "400", "--collect_steps", "200",
              "--eval_steps", "200", "--epochs", "1"]  # phase 17
PROTO_METHODS = ["None", "Reg@0.3", "Mask", "None:Oreo"]
PROTO_OUT = ("[collect]", "[human_gaze]", "[misperceive_gaze]", "[confound]", "[resume]", "[train:",
             "[eval:", "[done")  # the protocol's own lines of output, printed as they are
XOSC_TICKS, XOSC_COLLECT = 120, "CyclistCrossing.xosc"  # phase 18
CONFOUND_EPISODES = 2  # phase 18: build_confounded over the first two of phase 14's episodes


def overlay_masks(actions):
    """The confounding overlay's masks on the card, [T, H, W] each: where
    ops/raster.confounded_overlay paints the brake dot and the steering bar
    for these actions (on a blank frame: 1.0 the dot, 0.95 the bar)."""
    import numpy as np

    from gabril_carla_tpu_torch.ops.raster import confounded_overlay

    marks = confounded_overlay(torch.zeros(len(actions), 180, 320, device="cuda"),
                               torch.from_numpy(actions).cuda()).cpu().numpy()
    return marks == np.float32(1.0), marks == np.float32(0.95)


def protocol_phase(card: str, tmp) -> tuple[dict, dict, float]:
    """Phase 17: cli/full_benchmark.py's main at reduced depth (PROTO_ARGS)
    with the methods PROTO_METHODS (the regularizer, the UNet predictor's
    heat, the VQ-VAE), into ``tmp``; then the same command again (it must
    train nothing), and a confounded, misperceived-gaze call from the first
    one's cache. Returns (record, K1 launches by stage, K1's error against
    its plain version at the collection's final state)."""
    from pathlib import Path
    from unittest import mock

    import numpy as np

    from gabril_carla_tpu_torch.cli import full_benchmark as FB
    from gabril_carla_tpu_torch.ops.render_kernel import render_kernel

    seen = {"collect": [], "eval": [], "trainers": [], "raw_gazes": None, "confounded": None}
    collect_fn, make_rollout_fn, collect_expert, confound_store = (
        FB.collect, FB.make_rollout_fn, FB.collect_expert, FB.confound_store)

    def run_collect(spec, steps, draws, *args, **kwargs):
        before = render_kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collect_fn(spec, steps, draws, *args, **kwargs)
        torch.cuda.synchronize()
        seen["collect"].append({"spec": spec, "state": out[0], "steps": steps,
                                "launches": render_kernel.launches - before,
                                "s": time.perf_counter() - t0})
        return out

    def run_collect_expert(*args, **kwargs):
        store, records = collect_expert(*args, **kwargs)
        seen["raw_gazes"] = np.concatenate(store.gazes)  # before the gaze variant rewrites them
        seen["store"] = store
        return store, records

    def run_confound(store):
        confound_store(store)
        seen["confounded"] = store

    def counted_rollout(*args, **kwargs):
        roll = make_rollout_fn(*args, **kwargs)

        def run(spec, params, keys):
            before = render_kernel.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = roll(spec, params, keys)
            torch.cuda.synchronize()
            seen["eval"].append({"launches": render_kernel.launches - before, "steps": kwargs["steps"],
                                 "worlds": int(spec.route_len.shape[0]), "s": time.perf_counter() - t0})
            return out
        return run

    class Trainer(FB.Trainer):
        def train(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().train(*args, **kwargs)
            torch.cuda.synchronize()
            bc = self.mode == "bc"
            seen["trainers"].append((self.mode, self.cfg.gaze["method"] if bc else "-",
                                     self.cfg.dropout["method"] if bc else "-", time.perf_counter() - t0,
                                     self.steps_per_epoch))
            return out

    def drive(args, counted):
        buf = io.StringIO()
        with mock.patch.multiple(FB, collect=run_collect, collect_expert=run_collect_expert,
                                 confound_store=run_confound, make_rollout_fn=counted_rollout,
                                 Trainer=Trainer), contextlib.redirect_stdout(buf):
            torch.cuda.synchronize()
            if counted:
                render_kernel.launches = 0
            t0 = time.perf_counter()
            FB.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            if line.startswith(PROTO_OUT):
                log(f"[protocol] {line}")
        return wall

    cache, out = Path(tmp) / "store.npz", Path(tmp) / "protocol"
    first = PROTO_ARGS + ["--methods", *PROTO_METHODS, "--store_cache", str(cache), "--out", str(out)]
    wall = drive(first, counted=True)
    launches = render_kernel.launches
    report = json.loads((out / "report.json").read_text())
    n_collect, n_eval, n_trainers = len(seen["collect"]), len(seen["eval"]), len(seen["trainers"])
    col = seen["collect"][0]
    err = kernel_vs_plain("the protocol's collection, final state", operands(col["spec"], col["state"]))
    moved = (col["state"].ego.pos - col["spec"].spawn_pos).norm(dim=-1).cpu()
    store = seen["store"]
    frames = int(sum(len(x) for x in store.images))
    cached, records = FB.load_cache(cache)
    cached.finalize()
    cache_same = (np.array_equal(cached.flat_images, store.flat_images)
                  and np.array_equal(cached.flat_actions, store.flat_actions)
                  and np.array_equal(cached.flat_gazes, seen["raw_gazes"])
                  and np.array_equal(cached.lengths, store.lengths))
    expert = [r["scores"]["score_composed"] for r in records]

    wall_rerun = drive(first, counted=False)
    rerun_trained = len(seen["trainers"]) - n_trainers
    rerun_same = json.loads((out / "report.json").read_text()) == report

    conf_out = Path(tmp) / "protocol_confounded"
    wall_conf = drive(PROTO_ARGS + ["--methods", "None", "--store_cache", str(cache), "--out",
                                    str(conf_out), "--confounded", "--misperceive_gaze"], counted=False)
    conf_report = json.loads((conf_out / "report.json").read_text())
    conf = seen["confounded"]
    dot, bar = overlay_masks(cached.flat_actions)
    want = np.where(dot, 255, np.where(bar, 242, cached.flat_images[..., 0])).astype(np.uint8)
    overlay_exact = np.array_equal(conf.flat_images[..., 0], want)
    braked = int((cached.flat_actions[:, 2] > 0.8).sum())

    steps = int(PROTO_ARGS[PROTO_ARGS.index("--eval_steps") + 1])
    eval_launches = [e["launches"] for e in seen["eval"]]
    cells = {m: (c["seen"], c["unseen"]) for m, c in report["methods"].items()}
    cells.update({f"{m} (confounded)": (c["seen"], c["unseen"]) for m, c in conf_report["methods"].items()})
    log(f"[protocol] first call in {wall:.1f} s: collection {col['steps']} ticks x "
        f"{int(col['spec'].route_len.shape[0])} worlds in {col['s']:.1f} s, {frames} frames, "
        f"{frames / col['s']:.1f} frames/s; render launches {col['launches']} (want {col['steps']}); "
        f"median world moved {float(moved.median()):.1f} m; expert mean {report['expert_seen_mean']:.2f}, "
        f"worlds scoring 0: {sum(x <= 0 for x in expert)} of {len(expert)}; on {card}")
    for mode, gaze, drop, s, spe in seen["trainers"][:n_trainers]:
        log(f"[protocol] trainer {mode} (gaze {gaze}, dropout {drop}): {s:.1f} s, {spe} steps an epoch")
    for e in seen["eval"][:n_eval]:
        log(f"[protocol] eval rollout {e['worlds']} worlds x {e['steps']} ticks in {e['s']:.1f} s, "
            f"render launches {e['launches']} (want {e['steps'] + 1})")
    log("[protocol] scores (seen, unseen): " + ", ".join(f"{m} ({a:.2f}, {b:.2f})" for m, (a, b) in cells.items()))
    log(f"[protocol] render launches in the first call {launches} (want {steps + 1} x {n_eval} + "
        f"{col['steps']}); cache reloads the same arrays: {cache_same}; rerun in {wall_rerun:.1f} s trained "
        f"{rerun_trained}, report unchanged: {rerun_same}; confounded call in {wall_conf:.1f} s: the "
        f"overlay exactly on its masks: {overlay_exact} ({braked} braking frames of "
        f"{len(cached.flat_actions)})")
    finite = all(math.isfinite(a) and math.isfinite(b) for a, b in cells.values())
    ok = (n_collect == 1 and col["launches"] == col["steps"] and n_eval == 2 * len(PROTO_METHODS)
          and len(eval_launches) == n_eval + 2 and all(x == steps + 1 for x in eval_launches) and launches == col["steps"] + n_eval * (steps + 1)
          and set(report["methods"]) == set(PROTO_METHODS) and finite and len(conf_report["methods"]) == 1
          and all(x > 0 for x in expert) and len(expert) == 20 and float(moved.median()) > COLLECT_MOVED_M
          and cache_same and not rerun_trained and rerun_same and overlay_exact and braked > 0
          and conf_report["confounded"] is True)
    if not ok:
        raise SystemExit("chip_smoke: the protocol: a K1 launch count is off, a cell lacks a finite score, "
                         "an expert world scored 0 or the median one did not move, the cache did not "
                         "reload the same arrays, the rerun trained, or the confounded store is off its masks")
    rec = {"wall_s": wall, "collect_s": col["s"], "frames": frames, "frames_per_s": frames / col["s"],
           "trainers": [{"mode": m, "gaze": g, "dropout": d, "s": s, "steps_per_epoch": spe}
                        for m, g, d, s, spe in seen["trainers"]],
           "eval_s": [e["s"] for e in seen["eval"]], "expert_seen_mean": report["expert_seen_mean"],
           "scores": cells, "rerun_s": wall_rerun, "confounded_s": wall_conf, "card": card}
    return rec, {"protocol collect": col["launches"], "protocol eval": sum(eval_launches[:n_eval])}, err


def tools_phase(card: str, episodes, tmp) -> tuple[dict, dict, float]:
    """Phase 18: eval_routes --xosc on each vendored storyboard (the one
    that needs the OpenDRIVE map must be refused naming RoadPosition) with
    phase 17's "None" checkpoint, collect --xosc on XOSC_COLLECT recording
    every tick's screen boxes, generate_pseudo_gaze from those boxes,
    build_confounded on the card and on the CPU over CONFOUND_EPISODES of
    phase 14's episodes (bitwise equal), and eval_routes --video (an mp4
    read back where cv2 imports, else an ImportError naming cv2). K1 runs
    at one world on each xosc path and is held to its plain version at its
    final state. Returns (record, K1 launches by path, worst K1 error)."""
    from pathlib import Path
    from unittest import mock

    import numpy as np

    from gabril_carla_tpu_torch.cli import build_confounded, collect, eval_routes
    from gabril_carla_tpu_torch.data.vendored import XOSC_EXAMPLES, xosc_example
    from gabril_carla_tpu_torch.env.constants import N_STATICS, N_VEHICLES, N_WALKERS
    from gabril_carla_tpu_torch.env.xosc import load_xosc
    from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
    from gabril_carla_tpu_torch.saliency.pseudo_gaze import (SceneGraphDetector, generate_pseudo_gaze,
                                                             scene_boxes)

    try:
        import cv2
    except ImportError:
        cv2 = None
    manifests = {p.parent: json.loads(p.read_text())
                 for p in (Path(tmp) / "protocol" / "runs").glob("*/*/checkpoints/params.json")}
    ckpt = next(d for d, m in manifests.items()  # the "None" cell's BC policy
                if "model_type" not in m and m["gaze_method"] == "None" and m["dp_method"] == "None")
    buf, errs, rec, by_path = io.StringIO(), [], {"card": card}, {}
    make_rollout_fn = eval_routes.make_rollout_fn
    final = {}

    def keep_final(*args, **kwargs):
        roll = make_rollout_fn(*args, **kwargs)

        def run(spec, params, keys):
            st, trace = roll(spec, params, keys)
            final.update(spec=spec, state=st)
            return st, trace
        return run

    # eval_routes --xosc (and --video on the first storyboard)
    video = None
    for i, name in enumerate(XOSC_EXAMPLES):
        path, out = xosc_example(name), Path(tmp) / "xosc_eval" / Path(name).stem
        args = ["--checkpoint", str(ckpt), "--xosc", str(path), "--steps", str(XOSC_TICKS),
                "--out", str(out)] + (["--video"] if i == 0 else [])
        try:
            rid = load_xosc(path)["id"]
        except ValueError as e:  # a storyboard that needs the OpenDRIVE map
            try:
                with contextlib.redirect_stdout(buf):
                    eval_routes.main(args)
            except ValueError as got:
                refused = str(got)
            else:
                refused = ""
            if "RoadPosition" not in refused:
                raise SystemExit(f"chip_smoke: eval_routes --xosc {name} was not refused: {e}")
            log(f"[tools] eval_routes --xosc {name}: refused ({refused})")
            continue
        if i == 0 and cv2 is None:
            try:
                with contextlib.redirect_stdout(buf):
                    eval_routes.main(args)
                raise SystemExit("chip_smoke: --video ran without cv2")
            except ImportError as got:
                if "cv2" not in str(got):
                    raise SystemExit(f"chip_smoke: --video failed without naming cv2: {got}") from got
                video = f"refused without cv2: {got}"
            args = args[:-1]
        with mock.patch.object(eval_routes, "make_rollout_fn", keep_final), contextlib.redirect_stdout(buf):
            render_kernel.launches = 0
            t0 = time.perf_counter()
            eval_routes.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = render_kernel.launches
        errs.append(kernel_vs_plain(f"eval_routes --xosc {name}, final state",
                                    operands(final["spec"], final["state"])))
        stats = json.loads((out / f"route_{rid}" / "seed_400" / "stats.json").read_text())
        ok = launches == XOSC_TICKS + 1 and stats["route_id"] == f"RouteScenario_{rid}"
        if i == 0 and cv2 is not None:
            cap = cv2.VideoCapture(str(out / f"route_{rid}" / "seed_400" / "rollout.mp4"))
            got = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                   int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
            cap.release()
            want = (max(int(final["state"].t[0]), 1), 320, 180)
            video = f"rollout.mp4 read back: {got[0]} frames of {got[1]}x{got[2]} (want {want})"
            ok = ok and got == want
        log(f"[tools] eval_routes --xosc {name}: route id {rid}, {wall:.1f} s, render launches {launches} "
            f"(want {XOSC_TICKS + 1}), score_composed {stats['scores']['score_composed']}, stats.json "
            f"names {stats['route_id']}")
        if not ok:
            raise SystemExit(f"chip_smoke: eval_routes --xosc {name}: K1 launched {launches} times, the "
                             f"stats.json names {stats['route_id']}, or the video is off ({video})")
        by_path[f"eval_routes --xosc {Path(name).stem}"] = launches
    log(f"[tools] eval_routes --video: {video}")

    # collect --xosc, recording each tick's screen boxes
    boxes, seen = [], {}
    collect_fn, expert_fn = collect.collect, collect.expert_action

    def run_collect(spec, steps, draws, *args, **kwargs):
        out = collect_fn(spec, steps, draws, *args, **kwargs)
        seen.update(spec=spec, state=out[0])
        return out

    def record_boxes(spec, state):
        boxes.append(scene_boxes(state))
        return expert_fn(spec, state)

    out = Path(tmp) / "xosc_collect"
    stem = Path(XOSC_COLLECT).stem
    with mock.patch.multiple(collect, collect=run_collect, expert_action=record_boxes), \
            contextlib.redirect_stdout(buf):
        render_kernel.launches = 0
        collect.main(["--xosc", str(xosc_example(XOSC_COLLECT)), "--steps", str(XOSC_TICKS),
                      "--seeds", "200", "--out", str(out)])
        torch.cuda.synchronize()
        launches = render_kernel.launches
    errs.append(kernel_vs_plain(f"collect --xosc {stem}, final state", operands(seen["spec"], seen["state"])))
    ep = out / f"route_{stem}" / "seed_200"
    stats = json.loads((ep / "stats.json").read_text())
    n = int(seen["state"].t[0])
    box_gap = float((scene_boxes(tree_to(seen["state"], "cpu"))
                     - scene_boxes(seen["state"]).cpu()).abs().max())
    by_path[f"collect --xosc {stem}"] = launches

    # pseudo-gaze from the collected boxes
    recorded = torch.stack(boxes[:n])[:, 0].cpu().numpy()  # [n, A, 8]
    dynamic = np.concatenate([np.ones(N_VEHICLES, bool), np.zeros(N_STATICS, bool), np.ones(N_WALKERS, bool)])
    pg = np.load(generate_pseudo_gaze(ep, SceneGraphDetector(recorded, dynamic, dynamic_only=True), n,
                                      (180, 320)))["gaze"]
    detected = int((pg[:, 0] >= 0).sum())
    log(f"[tools] collect --xosc {stem}: {n} ticks, render launches {launches} (want {XOSC_TICKS}), "
        f"stats.json names {stats['route_id']}, score_composed {stats['scores']['score_composed']}; "
        f"screen boxes recorded {len(boxes)}, card against CPU at the final state {box_gap:.3g}; "
        f"gaze_pseudo.npz {pg.shape}, {detected} frames with a dynamic actor detected")
    ok = (launches == XOSC_TICKS and stats["route_id"] == f"RouteScenario_{stem}" and pg.shape == (n, 10)
          and len(boxes) == XOSC_TICKS and box_gap <= 1e-3 and detected > 0)
    if not ok:
        raise SystemExit("chip_smoke: collect --xosc or the pseudo-gaze from its boxes is off")

    # build_confounded on the card and on the CPU
    src = Path(tmp) / "confound_src"
    for ep in sorted(Path(episodes).glob("route_*/seed_*"))[:CONFOUND_EPISODES]:
        (src / ep.parent.name).mkdir(parents=True, exist_ok=True)
        (src / ep.parent.name / ep.name).symlink_to(ep)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        build_confounded.main(["--dataset_root", str(src), "--out_root", str(Path(tmp) / "conf_card")])
        t_card = time.perf_counter() - t0
        build_confounded.main(["--dataset_root", str(src), "--out_root", str(Path(tmp) / "conf_cpu")],
                              device="cpu")
    files = sorted(p.relative_to(Path(tmp) / "conf_card") for p in (Path(tmp) / "conf_card").rglob("*.npz"))
    unequal = [str(f) for f in files
               if not all(np.array_equal(a[k], b[k]) for a, b in [(np.load(Path(tmp) / "conf_card" / f),
                                                                    np.load(Path(tmp) / "conf_cpu" / f))]
                          for k in a.files)]
    cpu_files = sorted(p.relative_to(Path(tmp) / "conf_cpu") for p in (Path(tmp) / "conf_cpu").rglob("*.npz"))
    log(f"[tools] build_confounded over {CONFOUND_EPISODES} of phase 14's episodes: {len(files)} files on "
        f"the card in {t_card:.1f} s; card against CPU: unequal {unequal}")
    if files != cpu_files or len(files) != 3 * CONFOUND_EPISODES or unequal:
        raise SystemExit("chip_smoke: build_confounded on the card differs from the CPU's")
    rec.update(xosc_ticks=XOSC_TICKS, video=video, confound_card_s=t_card, pseudo_gaze_frames=detected)
    return rec, by_path, max(errs)


DIST_BATCH = 64  # phase 19: the all-reduced step's batch (full width, bf16, gaze None)
DIST_TICKS, DIST_KEY = 40, 19  # phase 19: the sharded eval's ticks and key on the 20 routes
DIST_PROFILE_STEPS = 3  # phase 19: grouped steps in its profiler window
DRAWS_SIZES = ((20, 1600), (120, 900))  # phase 19: env_draws of one eval split, the collection
# the wall times of those stages in the real-size protocol on the card
# (PERF.md section 5): a split's eval and the collection; env_draws must stay
# under 5% of them
DRAWS_STAGE_S = {(20, 1600): 49.0, (120, 900): 39.0}


@contextlib.contextmanager
def one_rank_group(backend: str):
    """A process group of this process alone (world size 1), joined
    through a file rendezvous in a temporary directory."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv", rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def trees_equal(a, b) -> bool:
    from gabril_carla_tpu_torch.parallel.mesh import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@contextlib.contextmanager
def cudnn_deterministic():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def allreduce_step_check(mesh, batch_size: int = DIST_BATCH) -> dict:
    """The full-width bf16 BC step (gaze None, so no scatter of heat) with
    the mesh's 'data' group against the same step without one, from one
    state and batch under cuDNN's deterministic algorithms: the new
    parameters, optimizer state and metrics bitwise equal, with a second
    plain step as the control. Then the time of one all-reduce of the
    step's gradient and metric bucket, and of both steps (CUDA events).
    Fatal on a mismatch."""
    import torch.distributed as dist

    from gabril_carla_tpu_torch.parallel.mesh import data_group, pmean
    from gabril_carla_tpu_torch.train.bc import init_bc_state, loss_and_grads, make_bc_train_step
    from gabril_carla_tpu_torch.train.optim import build_optimizer
    from gabril_carla_tpu_torch.utils.prng import prng_key

    cfg = bench_train_cfg(batch_size)
    cfg["gaze"]["method"] = "None"
    tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, 10)
    models, state = init_bc_state(cfg, prng_key(0), tx, "cuda")
    batch = bench_batch(cfg, batch_size, "cuda")
    group = data_group(mesh)
    plain, grouped = make_bc_train_step(models, cfg), make_bc_train_step(models, cfg, group)

    def outcome(step):
        new, metrics = step(state, batch, None)
        return new.params, new.opt_state, metrics

    with cudnn_deterministic():
        first, control, reduced = outcome(plain), outcome(plain), outcome(grouped)
    control_ok, equal = trees_equal(first, control), trees_equal(first, reduced)
    _, metrics, grads = loss_and_grads(models, cfg, state.params, batch)
    floats = sum(v.numel() for v in (*grads.values(), *metrics.values()))
    ar_ms = time_ms(lambda: pmean((grads, metrics), group), 20)
    step_ms = time_ms(lambda: plain(state, batch, None), 5)
    grouped_ms = time_ms(lambda: grouped(state, batch, None), 5)
    profile_window("distributed", f"{DIST_PROFILE_STEPS} grouped steps",
                   lambda: [grouped(state, batch, None) for _ in range(DIST_PROFILE_STEPS)])
    stages = span_stages("distributed", "train.step")
    log(f"[distributed] BC step at batch {batch_size} (full width, bf16): grouped step bitwise the "
        f"plain one {equal} (plain twice: {control_ok}); one all-reduce of {floats} float32 "
        f"({4 * floats / 2**20:.2f} MiB) {ar_ms:.4f} ms at world size {dist.get_world_size()}; step "
        f"{step_ms:.3f} ms plain, {grouped_ms:.3f} ms grouped")
    if not (control_ok and equal):
        raise SystemExit("chip_smoke: the all-reduced step differs from the plain one at world size 1")
    return {"batch": batch_size, "bitwise": equal, "bucket_floats": floats, "allreduce_ms": ar_ms,
            "step_ms": step_ms, "grouped_step_ms": grouped_ms,
            "allreduce_stream_ms": stages["train.allreduce"]}


def sharded_eval_check(mesh, policy, cfg, params, specs, ticks: int, key_seed: int = DIST_KEY) -> dict:
    """rollout_routes over ``specs`` with the mesh against without it, the
    same key (twice without, as the control), under cuDNN's deterministic
    algorithms: final states and traces bitwise equal, the render kernel
    launched ticks + 1 times in the sharded run, and its frames at the final
    state held to the plain version (FLIP_PX, BAR_ABS). Fatal on a
    failure."""
    import torch.distributed as dist

    from gabril_carla_tpu_torch.env.world import to_torch
    from gabril_carla_tpu_torch.eval.rollout import make_rollout_fn, rollout_routes
    from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
    from gabril_carla_tpu_torch.utils.prng import prng_key

    fn = make_rollout_fn(policy, cfg, steps=ticks)
    key = prng_key(key_seed)
    walls = {}

    def run(name, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rollout_routes(specs, params, fn, key, **kw)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    with cudnn_deterministic():
        ref = run("plain")
        control = run("plain_again")
        render_kernel.launches = 0
        got = run("sharded", mesh=mesh)
        launches = render_kernel.launches
    control_ok, equal = trees_equal(ref, control), trees_equal(ref, got)
    n = specs.route_len.shape[0]
    err = kernel_vs_plain(f"the sharded eval's {n} worlds after {ticks} ticks",
                          operands(to_torch(specs, "cuda"), got[0]))
    log(f"[distributed] sharded eval, {n} worlds x {ticks} ticks at world size "
        f"{dist.get_world_size()}: states and trace bitwise the unsharded ones {equal} "
        f"(unsharded twice: {control_ok}); render launches {launches} (want {ticks + 1}); "
        f"wall s plain {walls['plain']:.3f}, {walls['plain_again']:.3f}, "
        f"sharded {walls['sharded']:.3f}")
    if not (control_ok and equal) or launches != ticks + 1:
        raise SystemExit("chip_smoke: the sharded eval differs from rollout_routes without a mesh")
    return {"worlds": n, "ticks": ticks, "bitwise": equal, "launches": launches, "max_abs_err": err,
            "wall_s": walls}


def distributed_phase(card: str, policy, cfg, params, base) -> tuple[dict, int, float]:
    """Phase 19: NCCL at world size 1 (the all-reduced step, the sharded
    eval, dryrun_multichip(1, "cuda")), dryrun_multichip(2, "cpu") in a
    subprocess, and env_draws' host time at DRAWS_SIZES."""
    import numpy as np

    from gabril_carla_tpu_torch.dryrun import dryrun_multichip
    from gabril_carla_tpu_torch.parallel import make_mesh
    from gabril_carla_tpu_torch.utils.prng import env_draws, prng_key

    out = {}
    t0 = time.perf_counter()
    with one_rank_group("nccl"):
        mesh = make_mesh(device="cuda")
        out["nccl_init_s"] = time.perf_counter() - t0
        out["step"] = allreduce_step_check(mesh)
        out["eval"] = sharded_eval_check(mesh, policy, cfg, params, base, DIST_TICKS)
        t0 = time.perf_counter()
        out["dryrun_cuda"] = dryrun_multichip(1, "cuda")
        out["dryrun_cuda"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    code = ("import json; from gabril_carla_tpu_torch.dryrun import dryrun_multichip; "
            "print(json.dumps(dryrun_multichip(2, 'cpu')))")
    from pathlib import Path

    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(Path(__file__).resolve().parent))
    for line in res.stdout.splitlines()[:-1]:
        log(f"[distributed] {line}")
    if res.returncode != 0:
        raise SystemExit(f"chip_smoke: dryrun_multichip(2, 'cpu') failed:\n{res.stderr[-3000:]}")
    out["dryrun_cpu2"] = json.loads(res.stdout.splitlines()[-1])
    out["dryrun_cpu2"]["wall_s"] = time.perf_counter() - t0
    out["env_draws_s"] = {}
    for b, steps in DRAWS_SIZES:
        keys = np.stack([prng_key(s * 100003 + 3100) for s in range(b)])
        t0 = time.perf_counter()
        env_draws(keys, steps)
        dt = time.perf_counter() - t0
        share = dt / DRAWS_STAGE_S[(b, steps)]
        out["env_draws_s"][f"{b}x{steps}"] = dt
        log(f"[distributed] env_draws for {b} worlds x {steps} ticks: {dt:.4f} s on the host, "
            f"{100 * share:.2f}% of the stage's {DRAWS_STAGE_S[(b, steps)]:.0f} s (bar 5%)")
        if share > 0.05:
            raise SystemExit("chip_smoke: env_draws takes over 5% of its stage")
    log(f"[distributed] dryrun_multichip(1, 'cuda') {out['dryrun_cuda']['wall_s']:.1f} s, "
        f"(2, 'cpu') {out['dryrun_cpu2']['wall_s']:.1f} s in a subprocess; on {card}")
    return out, out["eval"]["launches"], out["eval"]["max_abs_err"]


# --- the host-batch path, human driving and the tools (phases 20-21) ----------

HOST_DEMOS, HOST_STEPS = 8, 500  # phase 20: 4,000 frames at 180x320x3 (691 MB a batch of 2,000)
HOST_BATCHES = 5  # phase 20: timed batches of each gather
HUMAN_ROUTE, HUMAN_SEED = 3100, 200  # phase 21
# phase 21's scripted drive (200 ticks), then PROFILE_TICKS more inside profile_trace
HUMAN_KEYS = ([{"up"}] * 80 + [{"up", "left"}] * 30 + [{"up", "right"}] * 30 + [{"up"}] * 40
              + [{"down"}] * 20)
PROFILE_TICKS = 10
HUMAN_FPS_MS = 50.0  # JAX eval/human.py:145: fps=20.0, the budget of one tick
VIZ_FRAMES, VIZ_STRIDE, VIZ_TOL = 60, 2, 1e-5  # phase 21: cli/visualize.py's defaults


def host_store():
    """Phase 20's in-memory store: HOST_DEMOS x HOST_STEPS frames of
    180x320x3 uint8 with synthetic_episodes' gaze and actions."""
    from gabril_carla_tpu_torch.data.dataset import synthetic_episodes

    return synthetic_episodes(n_demos=HOST_DEMOS, steps=HOST_STEPS, seed=0).finalize()


def gathers_agree(store, batch_size: int, reps: int, seed: int = 0) -> tuple[bool, dict, dict]:
    """BCDataset.sample through the native library and through the numpy
    loop on the same indices: the episode edges, then ``reps`` random
    batches of ``batch_size``. Returns (all bitwise equal, native ms, numpy
    ms per random batch)."""
    import numpy as np

    from gabril_carla_tpu_torch.data.dataset import BCDataset

    fast, loop = BCDataset(store, 2), BCDataset(store, 2, use_native=False)
    starts = store.offsets
    edges = np.concatenate([starts, starts + 1, starts + store.lengths - 1])
    same = all(np.array_equal(a, b) for a, b in zip(fast.sample(edges).values(),
                                                     loop.sample(edges).values()))
    rng = np.random.default_rng(seed)
    ms = {"native": [], "numpy": []}
    for _ in range(reps):
        idx = rng.permutation(len(fast))[:batch_size]
        got = {}
        for name, ds in (("native", fast), ("numpy", loop)):
            t0 = time.perf_counter()
            got[name] = ds.sample(idx)
            ms[name].append((time.perf_counter() - t0) * 1e3)
        same = same and all(np.array_equal(got["native"][k], got["numpy"][k]) for k in got["native"])
    return same, ms["native"], ms["numpy"]


def host_batch_phase(card: str, tmp) -> dict:
    """Phase 20: the native gather against the numpy loop on HOST_DEMOS x
    HOST_STEPS full-size frames (bitwise, then timed), a batch's copy to the
    card, and the BC Trainer on its host-batch path (training.device_data
    false) at bench_train.py's configuration, one epoch a run, two runs with
    each gather in turns."""
    import numpy as np

    from gabril_carla_tpu_torch.data.dataset import BCDataset
    from gabril_carla_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    store = host_store()
    made_s = time.perf_counter() - t0
    same, nat, loop = gathers_agree(store, TRAIN_BATCH, HOST_BATCHES)
    batch = BCDataset(store, 2).sample(np.arange(TRAIN_BATCH))
    nbytes = sum(v.nbytes for v in batch.values())
    copies = []
    for _ in range(HOST_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
        torch.cuda.synchronize()
        copies.append((time.perf_counter() - t0) * 1e3)
    out = {"frames": int(store.lengths.sum()), "store_s": made_s, "batch_bytes": nbytes,
           "native_ms": float(np.median(nat)), "numpy_ms": float(np.median(loop)),
           "copy_ms": float(np.median(copies)), "equal": same}
    log(f"[host] {out['frames']} frames of 180x320x3 uint8 made in {made_s:.1f} s; batch {TRAIN_BATCH} "
        f"({nbytes / 1e6:.1f} MB): native gather median {out['native_ms']:.2f} ms, numpy loop "
        f"{out['numpy_ms']:.2f} ms over {HOST_BATCHES} batches; the batch's copy to the card "
        f"{out['copy_ms']:.2f} ms; native and numpy bitwise equal (episode edges included): {same}; on {card}")
    if not same:
        raise SystemExit("chip_smoke: the native gather disagrees with the numpy loop")
    runs = {"native": [], "numpy": []}
    for i, name in enumerate(("numpy", "native", "native", "numpy")):  # in turns
        cfg = bench_train_cfg()
        cfg["training"].update(epochs=1, device_data=False)
        cfg["logging"]["log_dir"] = f"{tmp}/host_{i}"
        trainer = Trainer(cfg, BCDataset(store, 2, use_native=name == "native"), mode="bc")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = trainer.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stages = trainer.timer.summary()
        rec = {"steps": trainer.steps_per_epoch, "epoch_s": dt,
               "samples_per_s": trainer.steps_per_epoch * TRAIN_BATCH / dt, "loss": last["loss"],
               "data_ms": stages["data"]["mean_ms"], "step_ms": stages["step"]["mean_ms"]}
        runs[name].append(rec)
        log(f"[host] Trainer run {i + 1}, host batches through the {name} gather: {rec['steps']} steps "
            f"of {TRAIN_BATCH} in {dt:.3f} s, {rec['samples_per_s']:.1f} samples/s; StageTimer data "
            f"(the copy) {rec['data_ms']:.1f} ms, step (enqueue) {rec['step_ms']:.1f} ms; loss "
            f"{last['loss']:.5f}; on {card}")
        if trainer.device_mode or not all(math.isfinite(v) for v in last.values()):
            raise SystemExit(f"chip_smoke: the host-batch Trainer ({name}) gave a non-finite loss")
    out["trainer"] = runs
    cfg = bench_train_cfg()
    cfg["training"].update(epochs=1, device_data=False)
    cfg["logging"]["log_dir"] = f"{tmp}/host_profiled"
    trainer = Trainer(cfg, BCDataset(store, 2), mode="bc")
    profile_window("host", "a Trainer epoch", trainer.train)
    out["trainer_spans"] = span_stages("host", "trainer.step")
    return out


def human_drive(device, out_dir, keys, profile_dir=None, profile_ticks: int = 0):
    """Phase 21's drive: HumanLoop's core on HUMAN_ROUTE from HUMAN_SEED,
    one tick per entry of ``keys`` through a KeyboardController, dummy gaze
    from seed 0; then ``profile_ticks`` more of throttle inside
    profile_trace(profile_dir). Returns (loop, drive launches, profiled
    launches, per-tick wall ms of the drive)."""
    from gabril_carla_tpu_torch.env.world import load_benchmark_specs
    from gabril_carla_tpu_torch.eval.human import GazeSource, HumanLoop, KeyboardController
    from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
    from gabril_carla_tpu_torch.utils.profiling import profile_trace

    loop = HumanLoop(load_benchmark_specs([HUMAN_ROUTE]), out_dir, gaze="dummy", device=device)
    loop.gaze = GazeSource("dummy", seed=0)
    ctrl = KeyboardController()
    loop.start(HUMAN_SEED)
    walls = []
    render_kernel.launches = 0
    for k in keys:
        t0 = time.perf_counter()
        loop.tick(ctrl.action({name: True for name in k}), loop.gaze.sample())
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = render_kernel.launches
    profiled = 0
    if profile_ticks:
        render_kernel.launches = 0
        with profile_trace(profile_dir):
            for _ in range(profile_ticks):
                loop.tick(ctrl.action({"up": True}), loop.gaze.sample())
            torch.cuda.synchronize()
        profiled = render_kernel.launches
    return loop, launches, profiled, walls


def human_replay(loop, ep) -> tuple[bool, bool, dict]:
    """cli/collect.collect on the loop's spec with the recorded actions and
    the seed's draws: (frames bitwise the recorded ones, the same
    stats.json scores, the replay's record)."""
    import numpy as np

    from gabril_carla_tpu_torch.cli.collect import collect, seed_draws
    from gabril_carla_tpu_torch.env.criteria import compute_score
    from gabril_carla_tpu_torch.eval.stats import route_record

    obs = np.load(ep / "observations.npz")["observations"]
    acts = np.load(ep / "actions.npz")["actions"]
    n = len(acts)
    dev = loop.spec_t.route_len.device
    st, frames, _, _ = collect(loop.spec_t, n, seed_draws([loop.seed], n, dev), torch.from_numpy(acts).to(dev))
    score = {k: v[0].cpu() for k, v in compute_score(loop.spec_t, st).items()}
    rec = route_record(int(loop.spec.route_id[0]), loop.seed, score, duration_game=n * 0.05,
                       route_length=float(loop.spec.route_len[0]))
    rec = json.loads(json.dumps(rec))  # as stats.json holds it
    stats = json.loads((ep / "stats.json").read_text())
    return bool(np.array_equal(frames[:, 0].cpu().numpy(), obs[..., 0])), rec == stats, rec


def trace_kernel_launches(trace_dir, name: str = "render_kernel") -> int:
    """Device kernel events named ``name`` in the Chrome traces under
    ``trace_dir``."""
    from pathlib import Path

    n = 0
    for f in Path(trace_dir).glob("trace_*.json"):
        events = json.loads(f.read_text())["traceEvents"]
        n += sum(1 for e in events if e.get("cat") == "kernel" and name in e.get("name", ""))
    return n


def human_tools_phase(card: str, episodes, tmp) -> tuple[dict, dict, float]:
    """Phase 21: the human loop's core on the card, its episode replayed
    through collect, a profile_trace window, K1 at the final state, and
    visualize.panels card against CPU on one of phase 14's episodes.
    Returns (record, K1 launches by path, K1's error at the final state)."""
    from pathlib import Path

    import numpy as np

    from gabril_carla_tpu_torch.cli.visualize import panels

    t0 = time.perf_counter()
    loop, launches, profiled, walls = human_drive("cuda", Path(tmp) / "human", HUMAN_KEYS,
                                                  Path(tmp) / "trace", PROFILE_TICKS)
    drive_s = time.perf_counter() - t0
    ep = loop.save()
    n = loop.ticks
    files = {f: np.load(ep / f"{f}.npz")[f] for f in ("observations", "actions", "gaze")}
    stats = json.loads((ep / "stats.json").read_text())
    rows_ok = all(len(v) == n for v in files.values()) and files["observations"].shape[1:] == (180, 320, 3)
    named = stats["route_id"] == f"RouteScenario_{HUMAN_ROUTE}" and stats["seed"] == HUMAN_SEED
    in_trace = trace_kernel_launches(Path(tmp) / "trace")
    same_frames, same_record, rec = human_replay(loop, ep)
    err = kernel_vs_plain("the human loop's final state", operands(loop.spec_t, loop.state))
    wall = {"median": float(np.median(walls)), "p90": float(np.percentile(walls, 90)),
            "max": float(np.max(walls))}
    out = {"ticks": n, "drive_s": drive_s, "tick_ms": wall, "fps_budget_ms": HUMAN_FPS_MS,
           "launches": launches, "profiled_launches": profiled, "trace_launches": in_trace,
           "score_composed": stats["scores"]["score_composed"], "replay_frames_equal": same_frames,
           "replay_record_equal": same_record}
    log(f"[human] route {HUMAN_ROUTE} seed {HUMAN_SEED}: {len(HUMAN_KEYS)} scripted ticks + "
        f"{PROFILE_TICKS} profiled in {drive_s:.2f} s; a tick (render, the frame's copy to the host, "
        f"env step) median {wall['median']:.2f} ms, p90 {wall['p90']:.2f}, max {wall['max']:.2f} "
        f"against the {HUMAN_FPS_MS:.0f} ms of a 20 fps loop; K1 launches {launches} (want "
        f"{len(HUMAN_KEYS)}), {profiled} in the profiled window, {in_trace} render_kernel events "
        f"in its trace (want {PROFILE_TICKS}); on {card}")
    log(f"[human] saved {n} ticks (four files, one row a tick: {rows_ok}; stats.json names the pair: "
        f"{named}); score_composed {stats['scores']['score_composed']:.4f}, route "
        f"{stats['scores']['score_route']:.4f}; collect's replay: frames bitwise {same_frames}, "
        f"record equal {same_record}")
    if not (launches == len(HUMAN_KEYS) and profiled == in_trace == PROFILE_TICKS and rows_ok
            and named and same_frames and same_record):
        raise SystemExit("chip_smoke: the human loop failed a check (launches, trace, files, replay)")

    viz = Path(episodes) / f"route_{COLLECT_ROUTE}" / f"seed_{COLLECT_SEEDS[0]}"
    images = np.load(viz / "observations.npz")["observations"][: VIZ_FRAMES * VIZ_STRIDE : VIZ_STRIDE]
    gaze = np.load(viz / "gaze.npz")["gaze"][: VIZ_FRAMES * VIZ_STRIDE : VIZ_STRIDE]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    heat, tri = panels(images, gaze)
    card_s = time.perf_counter() - t0
    cheat, ctri = panels(images, gaze, device="cpu")
    heat_err = float(np.abs(heat - cheat).max())
    level = int(np.abs(tri.astype(np.int16) - ctri).max())
    out["visualize"] = {"frames": len(images), "card_s": card_s, "heat_max_abs": heat_err,
                        "panel_max_level": level}
    log(f"[tools] visualize.panels on {len(images)} frames of phase 14's {viz.parent.name}/{viz.name}: "
        f"card {card_s:.3f} s; heat against the CPU max abs {heat_err:.3g} (bar {VIZ_TOL:g}), "
        f"uint8 panels at most {level} level apart (bar 1)")
    if not (heat.shape == (len(images), 180, 320) and heat_err <= VIZ_TOL and level <= 1):
        raise SystemExit("chip_smoke: visualize.panels on the card disagrees with the CPU")
    return out, {"human": launches, "profile_trace": profiled}, err


# phase 22: JAX's random bits on the card (ops/threefry_kernel.py, csrc/threefry.cu)
# Its integer work is bounded by instruction issue: the H100's 67 TFLOP/s
# float32 peak (PEAK_F32_S) counts an FMA as 2 flops, so it is 128 lane
# instructions an SM a clock, all that an SM's four schedulers issue. That
# is an assumed ceiling, and one no threefry can reach: LOP3 and SHF issue
# at 64 an SM a clock, and only the adds could move to the IMAD pipe. So it
# can only make the bound shorter than the truth, never the kernel's share
# larger than it is.
PEAK_ISSUE_S = PEAK_F32_S / 2
# the fewest instructions an element: 20 rounds of add, rotate and xor (60);
# the second word's initial key add and 5 injections, their constants folded
# (6); the first word's last injection (1; its others and its initial add
# fuse into the next round's add, a 3-input IADD3); the words' xor, the shift
# and the or of the exponent (3); the subtraction of 1.0 (1)
THREEFRY_OPS = 71
THREEFRY_RUNS, THREEFRY_REPS = 7, 10  # timing: the median of 7 runs of 10 draws each
IGMD_STEPS = 10  # phase 22: timed BC steps at batch 2000 with IGMD
LAUNCHES_PER_STEP = {"None": 0, "GMD": 1, "IGMD": 2, "Oreo": 1}  # train/bc.py step_draws


def host_uniform(key, offset: int, m: int):
    """numpy's uniforms (utils/prng.py) at flat counters offset .. offset + m."""
    import numpy as np

    from gabril_carla_tpu_torch.utils import prng

    c = offset + np.arange(m, dtype=np.uint64)
    a, b = prng.threefry2x32(key[0], key[1], (c >> np.uint64(32)).astype(np.uint32),
                             (c & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (((a ^ b) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def median_ms(fn, runs=THREEFRY_RUNS, reps=THREEFRY_REPS) -> float:
    """The median over ``runs`` of time_ms(fn, reps)."""
    return sorted(time_ms(fn, reps) for _ in range(runs))[runs // 2]


def threefry_phase(card: str, tmp) -> dict:
    """Phase 22: the threefry kernel at bench_train.py's batch with IGMD."""
    import numpy as np

    from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes
    from gabril_carla_tpu_torch.models.encoder import igmd_hw
    from gabril_carla_tpu_torch.ops import threefry_kernel as TK
    from gabril_carla_tpu_torch.train.bc import init_bc_state, make_bc_train_step, step_draws
    from gabril_carla_tpu_torch.train.loop import Trainer
    from gabril_carla_tpu_torch.train.optim import build_optimizer
    from gabril_carla_tpu_torch.utils import prng

    def bits(t):
        return t.contiguous().view(torch.int32)

    cfg = bench_train_cfg()
    cfg["dropout"]["method"] = "IGMD"
    shapes = [(TRAIN_BATCH, 1, *hw) for hw in igmd_hw(cfg.data["img_height"], cfg.data["img_width"])]
    n_all = sum(math.prod(sh) for sh in shapes)
    # one step's two IGMD keys: the encoder's make_rng("dropout") keys of k_igmd
    k_igmd = prng.split(prng.prng_key(1), 4)[2]
    keys = [prng.flax_fold(k_igmd, i + 1) for i in range(2)]

    # the kernel against its plain version on the card, bitwise; slices of it against numpy
    equal, max_err, host_ok = True, 0.0, True
    for k, sh in zip(keys, shapes):
        n = math.prod(sh)
        got = TK.uniform(k, sh, "cuda").reshape(-1)
        plain = TK.random_floats_plain(k, n, "cuda")
        equal &= bool(torch.equal(bits(got), bits(plain)))
        max_err = max(max_err, float((got - plain).abs().max()))
        for off in (0, n // 2, n - 4096):
            host_ok &= bool(np.array_equal(got[off:off + 4096].cpu().numpy(), host_uniform(k, off, 4096)))
    small_full = bool(np.array_equal(TK.uniform(keys[1], shapes[1], "cuda").cpu().numpy(),
                                     prng.uniform(keys[1], shapes[1])))
    oreo_shape, p = (TRAIN_BATCH, 512), 1.0 - 0.5
    k_oreo = prng.split(prng.prng_key(1), 4)[3]
    mask = TK.bernoulli(k_oreo, p, oreo_shape, "cuda")
    equal &= bool(torch.equal(mask, TK.random_floats_plain(k_oreo, math.prod(oreo_shape), "cuda", p=p)
                              .reshape(oreo_shape)))
    host_ok &= bool(np.array_equal(mask.cpu().numpy(), prng.bernoulli(k_oreo, p, oreo_shape).astype(np.float32)))
    hi = 2**32 - 2048  # counters across the high word
    high = TK.random_floats(keys[0], 4096, "cuda", offset=hi)
    equal &= bool(torch.equal(bits(high), bits(TK.random_floats_plain(keys[0], 4096, "cuda", offset=hi))))
    host_ok &= bool(np.array_equal(high.cpu().numpy(), host_uniform(keys[0], hi, 4096)))
    log(f"[threefry] kernel against its plain version on the card at one IGMD step's draws "
        f"({' + '.join(str(list(sh)) for sh in shapes)} = {n_all / 1e6:.1f} M uniforms), Oreo's "
        f"[{TRAIN_BATCH}, 512] mask and counters across 2**32: bitwise {equal} (max abs {max_err:g}); "
        f"slices against numpy's threefry bitwise {host_ok}, the [{', '.join(map(str, shapes[1]))}] "
        f"draw whole {small_full}")
    if not (equal and host_ok and small_full):
        raise SystemExit("chip_smoke: the threefry kernel disagrees with its plain version or numpy")

    # its time beside its bound, the plain version's and torch.rand's
    def draw(fn):
        return lambda: [fn(k, sh) for k, sh in zip(keys, shapes)]

    k_ms = median_ms(draw(lambda k, sh: TK.uniform(k, sh, "cuda")))
    p_ms = median_ms(draw(lambda k, sh: TK.random_floats_plain(k, math.prod(sh), "cuda")), 3, 2)
    rand_ms = median_ms(draw(lambda k, sh: torch.rand(sh, device="cuda")))
    b_ops = n_all * THREEFRY_OPS / PEAK_ISSUE_S * 1e3
    b_bytes = n_all * 4 / PEAK_BYTES_S * 1e3
    b_ms, b_by = max((b_ops, "operations"), (b_bytes, "bytes"))
    log(f"[threefry] one step's IGMD draws ({n_all / 1e6:.1f} M uniforms, 2 launches): kernel {k_ms:.4f} "
        f"ms (median of {THREEFRY_RUNS} runs of {THREEFRY_REPS}); bound {b_ms:.4f} ms by {b_by} "
        f"({THREEFRY_OPS} instructions an element at {PEAK_ISSUE_S / 1e12:.2f} T/s; bytes "
        f"{b_bytes:.4f} ms), {100 * b_ms / k_ms:.1f}% of it; plain version {p_ms:.3f} ms; torch.rand "
        f"of the same shapes {rand_ms:.4f} ms (other bits: context, not a yardstick); on {card}")

    # launches a step for each dropout method (batch 16)
    per_step = {}
    for d in LAUNCHES_PER_STEP:
        c16 = bench_train_cfg(16)
        c16["dropout"]["method"] = d
        tx = build_optimizer(c16.optimizer, c16.scheduler, c16.training, steps_per_epoch=100)
        models, state = init_bc_state(c16, prng.prng_key(0), tx)
        batch = bench_batch(c16, 16, "cuda")
        TK.threefry_kernel.launches = 0
        make_bc_train_step(models, c16)(state, batch, prng.prng_key(1))
        per_step[d] = TK.threefry_kernel.launches
    log(f"[threefry] launches in one BC step by dropout method: {per_step} (want {LAUNCHES_PER_STEP})")
    if per_step != LAUNCHES_PER_STEP:
        raise SystemExit("chip_smoke: the train step's threefry launches are not one a draw")

    # the BC step at batch 2000 with IGMD, each step its own key
    tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=100)
    models, state = init_bc_state(cfg, prng.prng_key(0), tx)
    step = make_bc_train_step(models, cfg)
    batch = bench_batch(cfg, TRAIN_BATCH, "cuda")
    step_keys = prng.split(prng.prng_key(2), IGMD_STEPS + 1)
    state, _ = step(state, batch, step_keys[0])  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    TK.threefry_kernel.launches = 0
    start.record()
    for k in step_keys[1:]:
        state, metrics = step(state, batch, k)
    end.record()
    torch.cuda.synchronize()
    step_launches = TK.threefry_kernel.launches
    step_ms = start.elapsed_time(end) / IGMD_STEPS
    finite = all(math.isfinite(float(v)) for v in metrics.values())
    log(f"[threefry] bench_train.py's step with IGMD (batch {TRAIN_BATCH}, Reg, bf16): {step_ms:.3f} ms a "
        f"step over {IGMD_STEPS} steps, {TRAIN_BATCH / step_ms * 1e3:.1f} samples/s; the draws "
        f"{100 * k_ms / step_ms:.2f}% of it; threefry launches {step_launches} (want {2 * IGMD_STEPS}); "
        f"loss {float(metrics['loss']):.5f}")
    if step_launches != 2 * IGMD_STEPS or not finite:
        raise SystemExit("chip_smoke: the IGMD step did not launch the threefry kernel twice a step "
                         "or gave non-finite metrics")

    # the Trainer, the entry point: full width, IGMD, batch 64, device-resident
    tcfg = bench_train_cfg(64)
    tcfg["dropout"]["method"] = "IGMD"
    tcfg["training"].update(epochs=1, device_data=True)
    tcfg["logging"]["log_dir"] = str(tmp)
    trainer = Trainer(tcfg, BCDataset(synthetic_episodes(n_demos=4, steps=64), 2), mode="bc")
    TK.threefry_kernel.launches = 0
    last = trainer.train()
    trainer_launches = TK.threefry_kernel.launches
    want = 2 * trainer.steps_per_epoch
    log(f"[threefry] Trainer at full width with IGMD, 1 epoch of {trainer.steps_per_epoch} steps at batch "
        f"64: threefry launches {trainer_launches} (want {want}), loss {last['loss']:.5f}")
    if trainer_launches != want or not math.isfinite(last["loss"]):
        raise SystemExit("chip_smoke: the Trainer's IGMD steps did not launch the threefry kernel twice a step")

    # a card Trainer against a CPU Trainer from one seed at the CPU tests' widths: the draws
    # each Trainer's steps drew from their keys, recorded as train/bc.py's step_draws returns them,
    # bitwise between the devices and against the key chain of train/loop.py
    import gabril_carla_tpu_torch.train.bc as bc_mod

    def flat(dr):
        return [t.detach().cpu() for name in sorted(dr) for t in (dr[name] if name == "igmd" else [dr[name]])]

    drawn_by = {}

    def recording(rng, *args, **kwargs):
        out = step_draws(rng, *args, **kwargs)
        if not isinstance(rng, dict):  # a dict passes drawn numbers on
            drawn_by[dev].append(flat(out))
        return out

    gaps = {}
    for d in ("GMD", "IGMD", "Oreo"):
        losses, drawn_by = [], {}
        for dev in ("cuda", "cpu"):
            drawn_by[dev] = []
            ncfg = narrow_cfg("None", d)
            ncfg["training"].update(epochs=2, device_data=True, seed=3)
            ncfg["logging"]["log_dir"] = str(tmp)
            store = synthetic_episodes(n_demos=2, steps=6, img_hw=(24, 48), max_points=3, seed=3)
            tr = Trainer(ncfg, BCDataset(store, 2), mode="bc", device=dev)
            bc_mod.step_draws = recording
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    losses.append(tr.train()["loss"])
            finally:
                bc_mod.step_draws = step_draws
        chain = []
        epoch_key = prng.prng_key(3 + 1)  # the Trainer's step key chain (train/loop.py)
        for _ in range(2):
            epoch_key, sub = prng.split(epoch_key)
            for _ in range(tr.steps_per_epoch):
                sub, k = prng.split(sub)
                chain.append(flat(step_draws(k, ncfg, 4, "cpu")))
        n_steps = len(chain)
        pairs = [(x, y) for seq in (drawn_by["cpu"], chain) for a, b in zip(drawn_by["cuda"], seq)
                 for x, y in zip(a, b)]
        draws_equal = (len(drawn_by["cuda"]) == len(drawn_by["cpu"]) == n_steps
                       and all(torch.equal(bits(x), bits(y)) for x, y in pairs))
        gaps[d] = {"loss_gap": abs(losses[0] - losses[1]) / abs(losses[1]), "draws_bitwise": draws_equal}
    log(f"[threefry] card Trainer against CPU Trainer, training.seed 3, 24x48, 2 epochs of "
        f"{tr.steps_per_epoch} steps: "
        + ", ".join(f"{d} loss gap {g['loss_gap']:.3g} (bar {LOSS_RTOL:g}), the {n_steps} steps' draws "
                    f"bitwise each other and the key chain {g['draws_bitwise']}" for d, g in gaps.items()))
    if not all(g["draws_bitwise"] and g["loss_gap"] <= LOSS_RTOL for g in gaps.values()):
        raise SystemExit("chip_smoke: a card Trainer disagrees with the CPU Trainer of its seed")
    return {"elements": n_all, "ms": k_ms, "plain_ms": p_ms, "torch_rand_ms": rand_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes_ms": b_bytes, "max_abs_err": max_err,
            "launches_per_step": per_step, "igmd_step_ms": step_ms, "igmd_step_launches": step_launches,
            "trainer_launches": trainer_launches, "card_vs_cpu_trainer": gaps, "card": card}


# phase 23: the measuring entry point gabril_carla_tpu_torch.bench (bench.py)
BENCH_WORLDS, BENCH_STEPS = 1024, 400  # bench.py's defaults
SHARE_STEPS, SHARE_REPS = 100, 3  # in-process runs at BENCH_WORLDS for the stage shares
SMALL_WORLDS, SMALL_STEPS = 256, 100  # the rate at the main path's batch, in the same process
TAG_WORLDS, TAG_STEPS = 64, 10  # bench's main with each skip flag and with --profile
BENCH_PROFILE_STEPS = 10  # the profiled run at BENCH_WORLDS
VARIANTS = {"full": (False, False), "skip_policy": (True, False), "skip_render": (False, True)}


def bench_line_ok(line: dict, mode: str) -> bool:
    return (set(line) == BENCH_KEYS and line["metric"] == "rendered_env_steps_per_sec_per_chip"
            and math.isfinite(line["value"]) and line["value"] > 0 and line["mode"] == mode)


def bench_main(*args: str) -> tuple[dict, dict]:
    """gabril_carla_tpu_torch.bench's main in this process: (its last
    stdout line, its bench_stats). Echoes its stderr; fatal unless it
    returns 0."""
    import contextlib
    import io

    from gabril_carla_tpu_torch import bench as B

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = B.main(list(args))
    stats = {}
    for line in err.getvalue().splitlines():
        if line.startswith('{"bench_stats"'):
            stats = json.loads(line)["bench_stats"]
        else:
            log(f"[bench] {line}")
    if rc != 0 or not out.getvalue().strip():
        raise SystemExit(f"chip_smoke: bench's main {' '.join(args)} returned {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), stats


def spread_share(full: list, skip: list):
    """The share of a tick that a stage takes, by subtraction: from the
    median tick times, and the spread of the per-repetition shares (each
    repetition ran its variants back to back). None where the spread is
    not smaller than the share: the runs do not resolve it."""
    import statistics

    share = 1.0 - statistics.median(skip) / statistics.median(full)
    each = [1.0 - s / f for f, s in zip(full, skip)]
    spread = max(each) - min(each)
    return (share if spread < abs(share) else None), spread


def bench_phase(card: str, tmp, policy, cfg, params) -> dict:
    """Phase 23: bench at its defaults as a user runs it; its main with
    each skip flag and with --profile; then bench's loop in process with
    the main path's policy (bench's: gaze None, bf16, full width,
    prng_key(0)), alternating the variants for the stage shares at
    BENCH_WORLDS, K1 held to its plain version on the final state of the
    last full run there and timed there."""
    import statistics
    from pathlib import Path
    from unittest import mock

    from gabril_carla_tpu_torch import bench as B
    from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
    from gabril_carla_tpu_torch.utils.prng import prng_key, split

    torch.cuda.empty_cache()  # leave the card's memory to the subprocess
    line, stats, wall = run_entry("bench")
    if not (bench_line_ok(line, "real_routes") and stats.get("render_launches") == BENCH_STEPS):
        raise SystemExit(f"chip_smoke: bench at its defaults gave {line} with {stats.get('render_launches')} "
                         f"render launches (want {BENCH_STEPS})")
    rec = {"bench": line, "bench_stats": stats, "bench_wall_s": wall}

    for tag, want in (("skip_policy", TAG_STEPS), ("skip_render", 0)):
        line, stats = bench_main(str(TAG_WORLDS), str(TAG_STEPS), f"--{tag}")
        if not (bench_line_ok(line, f"real_routes+{tag}") and stats.get("render_launches") == want):
            raise SystemExit(f"chip_smoke: bench --{tag} gave {line}, {stats.get('render_launches')} "
                             f"render launches (want {want})")
    _, stats = bench_main(str(BENCH_WORLDS), str(BENCH_PROFILE_STEPS), "--profile",
                          str(Path(tmp) / "bench_profile"))
    rec["profile"] = stats["profile"]
    log(f"[bench] device busy {100 * stats['profile']['busy_ms'] / stats['profile']['wall_ms']:.1f}% of "
        f"a {BENCH_PROFILE_STEPS}-tick eval rollout at {BENCH_WORLDS} worlds")

    # in process: the variants alternated, SHARE_REPS runs each; the final
    # state of each run recorded for K1's check
    final = {}

    class Env(B.DrivingEnv):
        def step(self, *args):
            final["state"] = super().step(*args)
            return final["state"]

    def timed(run, spec, keys):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(spec, params, keys)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    spec = B.bench_worlds(BENCH_WORLDS, False, "cuda")
    keys = split(prng_key(0), BENCH_WORLDS)
    with mock.patch.object(B, "DrivingEnv", Env):
        runs = {v: B.make_bench_run(policy, cfg, SHARE_STEPS, *flags) for v, flags in VARIANTS.items()}
    for v, flags in VARIANTS.items():
        B.make_bench_run(policy, cfg, 2, *flags)(spec, params, keys)  # warm-up
    tick_ms = {v: [] for v in VARIANTS}
    for _ in range(SHARE_REPS):
        for v, run in runs.items():
            tick_ms[v].append(timed(run, spec, keys) * 1e3 / SHARE_STEPS)
            if v == "full":
                state = final["state"]
    shares, spreads = {}, {}
    for stage, v in (("policy", "skip_policy"), ("render", "skip_render")):
        shares[stage], spreads[stage] = spread_share(tick_ms["full"], tick_ms[v])
    if None not in shares.values():
        shares["env step and the rest"] = 1.0 - shares["policy"] - shares["render"]
    med = {v: statistics.median(t) for v, t in tick_ms.items()}
    log(f"[bench] {BENCH_WORLDS} worlds x {SHARE_STEPS} ticks, {SHARE_REPS} runs of each variant alternated, "
        "wall ms a tick: " + "; ".join(f"{v} " + ", ".join(f"{t:.3f}" for t in ts) for v, ts in tick_ms.items())
        + "; stage shares of the median by subtraction: "
        + ", ".join(f"{k} " + ("not resolved" if shares[k] is None else f"{100 * shares[k]:.1f}%")
                    + (f" (spread {100 * spreads[k]:.1f} points)" if k in spreads else "") for k in shares) + f"; on {card}")
    rec.update(share_worlds=BENCH_WORLDS, share_steps=SHARE_STEPS, tick_ms=tick_ms, median_tick_ms=med,
               stage_shares=shares, stage_share_spreads=spreads,
               steps_per_s_in_process=BENCH_WORLDS * 1e3 / med["full"])

    # the rate at the main path's batch, full variant only
    spec_small = B.bench_worlds(SMALL_WORLDS, False, "cuda")
    keys_small = split(prng_key(0), SMALL_WORLDS)
    run = B.make_bench_run(policy, cfg, SMALL_STEPS)
    B.make_bench_run(policy, cfg, 2)(spec_small, params, keys_small)  # warm-up
    small = [timed(run, spec_small, keys_small) for _ in range(SHARE_REPS)]
    rate = SMALL_WORLDS * SMALL_STEPS / statistics.median(small)
    log(f"[bench] {SMALL_WORLDS} worlds x {SMALL_STEPS} ticks in process: runs "
        + ", ".join(f"{t:.3f}" for t in small) + f" s, median {rate:.1f} env steps/s; at {BENCH_WORLDS} "
        f"worlds {rec['steps_per_s_in_process']:.1f}; on {card}")
    rec[f"steps_per_s_{SMALL_WORLDS}x{SMALL_STEPS}"] = rate
    rec[f"wall_s_{SMALL_WORLDS}x{SMALL_STEPS}"] = small

    # K1 on the final state of the last full run at BENCH_WORLDS
    ops = operands(spec, state)
    err = kernel_vs_plain(f"bench's {BENCH_WORLDS} worlds after {SHARE_STEPS} ticks", ops)
    k_ms = time_ms(lambda: render_kernel(*ops), 50)
    p_ms = time_ms(lambda: plain_chunked(ops), 2)
    b_ms, b_by, full_ms = bound(ops)
    log(f"[time] render kernel at {BENCH_WORLDS} worlds: {k_ms:.4f} ms; plain version {p_ms:.3f} ms; "
        f"bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / k_ms:.1f}% of the bound); full-loop bound "
        f"{full_ms:.4f} ms; on {card}")
    rec["k1_at_bench_worlds"] = {"worlds": BENCH_WORLDS, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "bound_full_loop_ms": full_ms, "max_abs_err": err}
    rec["card"] = card
    return rec


# phase 24: the frozen gaze UNet's forward as CUDA kernels (ops/unet_kernel.py, csrc/unet.cu)
UNET_WORLDS = 2048  # drivebench's mask_unet.eval_w2048: one heat call a tick
UNET_REPS = 10
UNET_MFLOP = 773.0  # a 180x320 sample's products (drivebench/counts/flops.py unet_layers)


class UnetBytes:
    """unet_forward's ops on meta tensors, counting the bytes each kernel
    has to move: its inputs read once, its output written once."""

    def __init__(self):
        self.bytes = 0

    def _new(self, shape, dtype=torch.bfloat16):
        t = torch.empty(shape, dtype=dtype, device="meta")
        self.bytes += t.numel() * t.element_size()
        return t

    def _read(self, *ts):
        self.bytes += sum(t.numel() * t.element_size() for t in ts if t is not None)

    def conv3x3(self, a, ss_a, mode, skip, ss_skip, weight, bias):
        from gabril_carla_tpu_torch.ops.unet_kernel import GROUPS, POOL

        self._read(a, ss_a, skip, ss_skip)
        b, h, w, _ = a.shape
        h, w = (h // 2, w // 2) if mode == POOL else (h, w)
        return self._new((b, h, w, weight.shape[0])), self._new((b, 1, GROUPS, 3), torch.float32)

    def finalize(self, part, gamma, beta):
        self._read(part)
        return self._new((part.shape[0], gamma.shape[0], 2), torch.float32)

    def conv_t(self, x, ss, weight, bias, pad_h):
        self._read(x, ss)
        b, h, w, _ = x.shape
        return self._new((b, 2 * h + pad_h, 2 * w, weight.shape[1]))

    def out1x1(self, x, ss, weight, bias):
        self._read(x, ss)
        return self._new((*x.shape[:3], weight.shape[0]))


def unet_phase(card: str) -> dict:
    """Phase 24: the UNet kernels at the mask_unet eval cell's batch."""
    from torch.func import functional_call

    from gabril_carla_tpu_torch.models.unet import UNet
    from gabril_carla_tpu_torch.ops import unet_kernel as UK

    b = UNET_WORLDS
    model = UNet(2, 1, dtype=torch.bfloat16).cuda()
    gen = torch.Generator(device="cuda").manual_seed(24)
    params = {}
    for name, v in model.state_dict().items():
        x = torch.randn(v.shape, generator=gen, device="cuda")
        if name.endswith("weight") and v.dim() >= 2:  # drivebench's draws (common.make_params)
            x = x * math.sqrt(2.0 / math.prod(v.shape[1:])) * (0.1 if name.startswith("out.") else 1.0)
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.01 * x
        params[name] = x
    obs = torch.rand((b, 180, 320, 2), generator=gen, device="cuda")

    def kernels():
        return UK.unet_forward(model, params, obs)

    def module():
        return functional_call(model, params, (obs.permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)

    before = UK.unet_kernel.launches
    got = kernels()
    torch.cuda.synchronize()
    launches = UK.unet_kernel.launches - before
    again = kernels()
    bitwise = torch.equal(got.view(torch.int16), again.view(torch.int16))
    del again
    plain = UK.unet_forward(model, params, obs, UK.PlainOps())
    lib = module()
    torch.cuda.synchronize()

    def rel(x, y):
        x, y = x.double(), y.double()
        return ((x - y).norm() / y.norm()).item()

    gap_plain, gap_module = rel(got, plain), rel(got, lib)
    del plain, lib
    torch.cuda.empty_cache()
    k_ms = time_ms(kernels, UNET_REPS)
    p_ms = time_ms(lambda: UK.unet_forward(model, params, obs, UK.PlainOps()), 2)
    l_ms = time_ms(module, UNET_REPS)
    counter = UnetBytes()
    UK.unet_forward(model, {k: v.to("meta") for k, v in params.items()}, obs.to("meta"), counter)
    t_bytes = 1e3 * counter.bytes / PEAK_BYTES_S
    t_ops = 1e3 * UNET_MFLOP * 1e6 * b / PEAK_BF16_S
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log(f"[unet] {b} rings, 180x320: kernels {k_ms:.3f} ms a forward ({launches} launches, bitwise "
        f"repeatable: {bitwise}); bound {b_ms:.3f} ms by {b_by} ({counter.bytes / 1e9:.2f} GB; "
        f"{100 * b_ms / k_ms:.1f}% of it; products {t_ops:.3f} ms); plain version {p_ms:.3f} ms; "
        f"module's cuDNN forward (library_ms) {l_ms:.3f} ms; relative L2 to the plain version "
        f"{gap_plain:.5f}, to the module {gap_module:.5f}; on {card}")
    if launches != UK.LAUNCHES_PER_FORWARD or not bitwise or not gap_plain <= 8 * 2.0 ** -8:
        raise SystemExit(f"chip_smoke: the UNet kernels launched {launches} times, bitwise {bitwise}, "
                         f"{gap_plain} from the plain version")
    return {"worlds": b, "launches": launches, "bitwise": bitwise, "rel_l2_plain": gap_plain,
            "rel_l2_module": gap_module, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": counter.bytes, "products_ms": t_ops,
            "card": card}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    import numpy as np

    from gabril_carla_tpu_torch.data.tasks import seen_routes, unseen_routes
    from gabril_carla_tpu_torch.env.criteria import compute_score
    from gabril_carla_tpu_torch.env.world import load_benchmark_specs, spec_rows, to_torch
    from gabril_carla_tpu_torch.eval.rollout import make_rollout_fn
    from gabril_carla_tpu_torch.ops import threefry_kernel as TK
    from gabril_carla_tpu_torch.ops import unet_kernel as UK
    from gabril_carla_tpu_torch.ops.render_kernel import build, render_kernel
    from gabril_carla_tpu_torch.train.bc import build_bc_models, init_bc_params, make_bc_policy_fn
    from gabril_carla_tpu_torch.utils.config import default_bc_config
    from gabril_carla_tpu_torch.utils.prng import env_draws, prng_key

    dev = "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind}; {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build: one nvcc a source, both started together
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        built = list(pool.map(lambda b: b(), (build, TK.build, UK.build)))
    for lib, build_log in built:
        log(f"[build] {lib.name} ({time.perf_counter() - t0:.1f} s for all three)")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    render_kernel.load()
    TK.threefry_kernel.load()
    UK.unet_kernel.load()

    # the policy and the worlds of the main path
    cfg = default_bc_config()
    cfg["gaze"]["method"] = "None"
    cfg["training"]["compute_dtype"] = "bfloat16"
    models = build_bc_models(cfg, dev)
    params = init_bc_params(models, cfg, prng_key(0))
    policy = make_bc_policy_fn(models, cfg)
    ids = seen_routes() + unseen_routes()
    base = load_benchmark_specs(ids)

    # 3. kernel vs plain
    spec20 = to_torch(base, dev)
    state40, _ = make_rollout_fn(policy, cfg, steps=COMPARE_TICKS)(spec20, params, tick_keys(len(ids), 1))
    from gabril_carla_tpu_torch.env.env import DrivingEnv

    errs = [
        kernel_vs_plain("20 real routes at reset", operands(spec20, DrivingEnv().reset(spec20))),
        kernel_vs_plain("crossing-flow scene", operands(*single_route(*_crossing_scene(), dev))),
        kernel_vs_plain("tight-loop route", operands(*single_route(*_tight_loop(), dev))),
        kernel_vs_plain("crowded scene", operands(*single_route(*_crowded(), dev))),
    ]
    for fd in (False, True):
        ops40 = operands(spec20, state40, far_decimate=fd)
        for lw in (False, True):
            errs.append(kernel_vs_plain(
                f"20 real routes after {COMPARE_TICKS} ticks, far_decimate={fd}, lower_window={lw}",
                ops40, far_decimate=fd, lower_window=lw))
    max_err = max(errs)

    # 4. main path at full width
    spec = to_torch(spec_rows(base, np.arange(N_WORLDS) % len(ids)), dev)
    m = cfg.model
    log(f"[main] policy: embedding {m['embedding_dim']}, hiddens {m['num_hiddens']}, "
        f"{m['num_residual_layers']} residual layers of {m['num_residual_hiddens']}, "
        f"z_dim {m['z_dim']}, frame stack {cfg.data['frame_stack']}, 180x320, bfloat16")
    rollout = make_rollout_fn(policy, cfg, steps=TICKS)
    rollout(spec, params, tick_keys(N_WORLDS, 2))  # warm-up run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    keys = tick_keys(N_WORLDS, 3)
    render_kernel.launches = 0
    t0 = time.perf_counter()
    state, trace = rollout(spec, params, keys)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = render_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] {N_WORLDS} worlds x {TICKS} ticks in {dt:.3f} s: "
        f"{N_WORLDS * TICKS / dt:.1f} env steps/s on {card}")
    # the run's env draws, JAX's for the worlds' keys, are computed on the
    # host before its first launch: their share of the run
    t_draws = time.perf_counter()
    env_draws(keys, TICKS)
    draws_s = time.perf_counter() - t_draws
    log(f"[main] env_draws for {N_WORLDS} worlds x {TICKS} ticks: {draws_s:.4f} s on the host, "
        f"{100 * draws_s / dt:.2f}% of the run")
    main_rec = {"worlds": N_WORLDS, "ticks": TICKS, "wall_s": dt, "steps_per_s": N_WORLDS * TICKS / dt,
                "env_draws_s": draws_s, "env_draws_share": draws_s / dt, "card": card}
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
    b_ms, b_by, full_ms = bound(ops)
    log(f"[time] render kernel at {N_WORLDS} worlds: {k_ms:.4f} ms; plain version {p_ms:.3f} ms; "
        f"bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / k_ms:.1f}% of the bound); full-loop bound "
        f"{full_ms:.4f} ms ({100 * full_ms / k_ms:.1f}%); on {card}")
    log("[time] no single PyTorch call computes this function: library_ms is null")

    # 6. where the time goes
    profile_window("breakdown", "10 ticks", lambda: make_rollout_fn(policy, cfg, steps=10)(
        spec, params, tick_keys(N_WORLDS)))
    span_stages("breakdown")
    log(f"[phases] 1-6 in {time.perf_counter() - t_all:.1f} s")

    # 7-9. BC training
    t_phase = time.perf_counter()
    train = train_phase(card)
    methods_phase()
    trainer_phase()
    log(f"[phases] 7-9 in {time.perf_counter() - t_phase:.1f} s")

    # 10-13. the gaze-heat eval path
    t_phase = time.perf_counter()
    gaze = gaze_phase(card)
    log(f"[phases] 10 in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    heat, heat_err = heat_phase(spec, card)
    max_err = max(max_err, heat_err)
    log(f"[phases] 11 in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    eval_launches = entry_points_phase(ids, base)
    log(f"[phases] 12 in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    card_vs_cpu_phase(spec20, state40)
    log(f"[phases] 13 in {time.perf_counter() - t_phase:.1f} s")

    # 14-16. the offline data-to-policy path
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        episodes = Path(tmp) / "episodes"
        t_phase = time.perf_counter()
        collected, collect_launches, collect_err = collect_phase(card, episodes)
        max_err = max(max_err, collect_err)
        log(f"[phases] 14 in {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        vq = vqvae_phase(card)
        log(f"[phases] 15 in {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        pipeline = pipeline_phase(card, episodes, Path(tmp) / "runs")
        log(f"[phases] 16 in {time.perf_counter() - t_phase:.1f} s")

        # 17-18. the full protocol and the data tools
        t_phase = time.perf_counter()
        protocol, protocol_launches, protocol_err = protocol_phase(card, tmp)
        max_err = max(max_err, protocol_err)
        log(f"[phases] 17 in {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        tools, tools_launches, tools_err = tools_phase(card, episodes, tmp)
        max_err = max(max_err, tools_err)
        log(f"[phases] 18 in {time.perf_counter() - t_phase:.1f} s")

        # 19. multi-GPU on torch.distributed, at world size 1 on this card
        t_phase = time.perf_counter()
        distributed, dist_launches, dist_err = distributed_phase(card, policy, cfg, params, base)
        max_err = max(max_err, dist_err)
        log(f"[phases] 19 in {time.perf_counter() - t_phase:.1f} s")

        # 20-21. the host-batch path with the native gather; human driving and the tools
        t_phase = time.perf_counter()
        host = host_batch_phase(card, tmp)
        log(f"[phases] 20 in {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        human, human_launches, human_err = human_tools_phase(card, episodes, tmp)
        max_err = max(max_err, human_err)
        log(f"[phases] 21 in {time.perf_counter() - t_phase:.1f} s")

        # 22. JAX's training draws on the card
        t_phase = time.perf_counter()
        threefry = threefry_phase(card, Path(tmp) / "threefry")
        log(f"[phases] 22 in {time.perf_counter() - t_phase:.1f} s")

        # 23. the measuring entry points
        t_phase = time.perf_counter()
        bench = bench_phase(card, tmp, policy, cfg, params)
        max_err = max(max_err, bench["k1_at_bench_worlds"]["max_abs_err"])
        log(f"[phases] 23 in {time.perf_counter() - t_phase:.1f} s")

        # 24. the gaze UNet's forward as CUDA kernels
        t_phase = time.perf_counter()
        unet = unet_phase(card)
        log(f"[phases] 24 in {time.perf_counter() - t_phase:.1f} s")
    log(f"[done] {time.perf_counter() - t_all:.1f} s in all")

    by_path = {"main": launches, **{f"heat {k}": v["launches"] for k, v in heat.items()},
               "eval_routes": eval_launches, "collect": collect_launches, **protocol_launches,
               **tools_launches, "sharded eval": dist_launches, **human_launches,
               "bench": bench["bench_stats"]["render_launches"]}
    print(json.dumps({"kernels": [{
        "name": "render", "route": "cuda", "source": "gabril_carla_tpu_torch/csrc/render.cu",
        "replaces": "gabril_carla_tpu/ops/pallas_raster.py:88", "launches": launches,
        "launches_by_path": by_path, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "bound_full_loop_ms": full_ms, "library_ms": None,
        "at_bench_worlds": bench["k1_at_bench_worlds"]}, {
        "name": "threefry", "route": "cuda", "source": "gabril_carla_tpu_torch/csrc/threefry.cu",
        "replaces": "gabril_carla_tpu/train/bc.py:222",
        "replaces_note": "no TPU kernel: jax.random's threefry, which XLA generated on the device",
        "launches": threefry["trainer_launches"],
        "launches_by_path": {"trainer IGMD": threefry["trainer_launches"],
                             "bench_train step IGMD": threefry["igmd_step_launches"],
                             **{f"one step {k}": v for k, v in threefry["launches_per_step"].items()}},
        "max_abs_err": threefry["max_abs_err"], "ms": threefry["ms"], "plain_ms": threefry["plain_ms"],
        "bound_ms": threefry["bound_ms"], "bound_by": threefry["bound_by"], "library_ms": None,
        "torch_rand_ms": threefry["torch_rand_ms"], "elements": threefry["elements"]}, {
        "name": "unet", "route": "cuda", "source": "gabril_carla_tpu_torch/csrc/unet.cu",
        "replaces": None, "replaces_note": "no TPU kernel: the JAX package's UNet convs and norms were XLA's",
        "launches": unet["launches"], "max_abs_err": None, "rel_l2_plain": unet["rel_l2_plain"],
        "ms": unet["ms"], "plain_ms": unet["plain_ms"], "bound_ms": unet["bound_ms"],
        "bound_by": unet["bound_by"], "library_ms": unet["library_ms"], "worlds": unet["worlds"]}]}))
    print(json.dumps({"main": main_rec}))
    print(json.dumps({"train": train}))
    print(json.dumps({"gaze_train": gaze}))
    print(json.dumps({"heat_rollouts": heat}))
    print(json.dumps({"collect": collected}))
    print(json.dumps({"vqvae_train": vq}))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"protocol": protocol}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"host_batches": host}))
    print(json.dumps({"human": human}))
    print(json.dumps({"threefry": threefry}))
    print(json.dumps({"bench": bench}))
    print(json.dumps({"unet": unet}))
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


def _mid_route():
    """30 m along a straight 200 m route: both lower-window gates engage."""
    import numpy as np

    wps = np.stack([np.arange(0.0, 200, 2.0), np.zeros(100)], 1).astype(np.float32)
    route = {"id": 5, "town": "T", "waypoints": wps, "scenarios": [], "weather": [5, 0, 2, 90]}

    def at(st):
        return st.replace(ego=st.ego.replace(pos=torch.tensor([[30.0, 0.0]], device=st.t.device),
                                             route_idx=torch.full_like(st.ego.route_idx, 30)))
    return route, at


def _crowded():
    """Thirty vehicles and six walkers placed ahead of the ego on the
    mid-route scene: more than 24 visible boxes (tests/test_raster.py:240)."""
    route, mid = _mid_route()

    def at(st):
        st = mid(st)
        dev = st.t.device
        veh, wk = st.vehicles, st.walkers
        k = min(veh.pos.shape[1], 30)
        grid = torch.stack([42.0 + 4.0 * (torch.arange(k) % 6), -6.0 + 2.5 * (torch.arange(k) // 6)], 1)
        pos, alive = veh.pos.clone(), veh.alive.clone()
        pos[0, :k], alive[0, :k] = grid.to(dev), True
        wpos, walive = wk.pos.clone(), wk.alive.clone()
        wpos[0, :6] = torch.stack([44.0 + 3.0 * torch.arange(6.0), torch.full((6,), 3.0)], 1).to(dev)
        walive[0, :6] = True
        return st.replace(vehicles=veh.replace(pos=pos, alive=alive),
                          walkers=wk.replace(pos=wpos, alive=walive))
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
    if sys.argv[1:2] == ["--resume-check"]:  # phase 16's subprocess
        print(json.dumps(resume_check(*sys.argv[2:5])))
        sys.exit(0)
    sys.exit(main())
