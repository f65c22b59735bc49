"""Smoke run of the PyTorch/CUDA port (gabril_carla_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit;
  2. build: nvcc compiles csrc/render.cu for sm_90a (registers, shared memory);
  3. kernel vs plain: the render kernel against its plain PyTorch version on
     the same operands, on the 20 real routes at reset and after 40 ticks
     (there under all four (far_decimate, lower_window) combinations), a
     crossing-flow scene, a tight-loop route and a crowded scene (more than
     24 visible boxes). Both visit the same rows and boxes, so the bar is
     near-exact: in every frame at most FLIP_PX pixels off by more than
     1e-5 (near ties of the argmin, which nvcc's FMA contraction can flip);
  4. main path: make_rollout_fn on the 20 real routes tiled to 256 worlds,
     full-width bf16 policy from a seeded generator, 100 ticks (warm-up
     included), timed after a warm-up run; the kernel must launch exactly
     ticks + 1 times in it; scores must be finite;
  5. the kernel at the main path's batch (its final state): held against
     the plain version at the same bar, then timed with CUDA events beside
     the plain version and the kernel's bound (the work of these operands'
     row sets, and the full-loop count beside it);
  6. where a tick's time goes: each stage's wall time, and a profiler
     window's device busy share and heaviest kernels;
  7. the BC train step at bench_train.py's configuration (batch 2000, Reg,
     bf16, full width), its batch resident on the card: one warm-up step,
     then TRAIN_STEPS timed with CUDA events; samples/s, step ms, peak
     memory, the FLOPs of a step (FlopCounterMode) and their share of the
     bf16 peak, the stage split and a profiler window; fatal unless the
     loss and metrics are finite, loss_reg > 0 and every parameter group
     moved;
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
     each stage's wall ms and a profiler window over 10 ticks; fatal unless
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
     optimizer state bitwise equal.
Prints JSON lines of the kernel records, the train step's, the gaze
predictor step's, the heat rollouts', the collection's, the VQ-VAE step's
and the pipeline's numbers, the card line, and last
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

N_WORLDS = 256
TICKS = 100
COMPARE_TICKS = 40
CHUNK = 8  # worlds per plain-version call (its [B, 87, 320, 160] distance tensor)
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM f32 outside the tensor cores
BAR_ABS, FLIP_PX = 1e-5, 4
TRAIN_BATCH, TRAIN_STEPS = 2000, 30  # bench_train.py's batch and timed steps
PEAK_BF16_S = 989e12  # H100 SXM dense bf16
# bench_train.py's step counted from the shapes: the encoder's convs and the
# pre-actor are 1.80 GFLOP a sample forward, x3 for forward and backward
FLOPS_COUNTED = 1.80e9 * 3 * TRAIN_BATCH
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


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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


def tick_draws(b: int, ticks: int = 10) -> torch.Tensor:
    """Seeded env draws for the short rollouts that phases 6 and 11 time."""
    from gabril_carla_tpu_torch.env.env import DRAWS_PER_STEP

    return torch.rand((ticks, b, DRAWS_PER_STEP), generator=torch.Generator(device="cuda").manual_seed(4),
                      device="cuda")


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


def stage_breakdown(spec, params, policy, cfg, kw, ticks=10) -> dict:
    """Where a tick's time goes: make_rollout_fn's own loop over ``ticks``
    ticks, the functions it calls wrapped so that each stage is synchronised
    around it: render (operand prep and K1; the reset's frame is spread over
    the ticks), heat (the frozen predictor, or analytic gaze and its splat),
    policy (both passes of the confounded two-pass), overlay, env step.
    Returns wall ms per tick; a stage that the path does not run reads 0."""
    from unittest import mock

    from gabril_carla_tpu_torch.env.env import DrivingEnv
    from gabril_carla_tpu_torch.eval import rollout as RO
    from gabril_carla_tpu_torch.ops.heatmap import GazeHeatmapper

    wall = dict.fromkeys(("render", "heat", "policy", "overlay", "env step"), 0.0)

    def timed(name, fn):
        return synced(wall, name, fn, ticks)

    class Env(DrivingEnv):
        step = timed("env step", DrivingEnv.step)

    class Heatmapper(GazeHeatmapper):
        heatmaps = timed("heat", GazeHeatmapper.heatmaps)

    kw = dict(kw)
    if kw.get("gaze_predictor_apply") is not None:
        kw["gaze_predictor_apply"] = timed("heat", kw["gaze_predictor_apply"])
    with mock.patch.multiple(RO, DrivingEnv=Env, GazeHeatmapper=Heatmapper,
                             render_frame=timed("render", RO.render_frame),
                             analytic_gaze=timed("heat", RO.analytic_gaze),
                             confounded_overlay=timed("overlay", RO.confounded_overlay)):
        rollout = RO.make_rollout_fn(timed("policy", policy), cfg, steps=ticks, **kw)
        rollout(spec, params, draws=tick_draws(spec.route_len.shape[0], ticks))
    return wall


def profile_window(tag, what, fn, top=8):
    """Run ``fn`` under torch.profiler; log the device's busy share of the
    wall time and the heaviest kernels; return (busy ms, wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in kernels.values()) / 1e3
    log(f"[{tag}] profiled {what}: device busy {busy:.3f} ms of {span:.3f} ms wall "
        f"({100 * busy / span:.1f}%), {sum(n for n, _ in kernels.values())} kernel launches")
    for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[{tag}] {us / 1e3:10.3f} ms {n:6d}x {name[:90]}")
    return busy, span


# --- BC training (phases 7-9) -------------------------------------------------


def bench_train_cfg(batch_size: int = TRAIN_BATCH):
    """bench_train.py's configuration: the defaults (full width, 180x320
    grayscale, frame stack 2, bf16) with Reg, mask_sigma 30."""
    from gabril_carla_tpu_torch.utils.config import default_bc_config

    cfg = default_bc_config()
    cfg["data"]["batch_size"] = batch_size
    cfg["gaze"].update(method="Reg", mask_sigma=30.0)
    cfg["training"]["compute_dtype"] = "bfloat16"
    return cfg


def bench_batch(cfg, batch_size: int, device, seed: int = 0) -> dict:
    """A batch made as bench_train.py:76-81 makes it, from numpy ``seed``."""
    import numpy as np

    s, p = cfg.data["frame_stack"], cfg.gaze["max_points"]
    h, w = cfg.data["img_height"], cfg.data["img_width"]
    host = np.random.default_rng(seed)
    batch = {"obs_seq": host.integers(0, 255, (batch_size, s, h, w, 1), dtype=np.uint8),
             "gaze_seq": host.random((batch_size, s, p * 2), dtype=np.float32),
             "actions": host.random((batch_size, cfg.data["action_dim"]), dtype=np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


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

    cfg = narrow_cfg(gaze, dropout)
    cpu = build_bc_models(cfg, "cpu")
    params = init_bc_params(cpu, cfg, torch.Generator().manual_seed(0))
    store = synthetic_episodes(n_demos=1, steps=8, img_hw=(24, 48), max_points=3)
    batch = next(BCDataset(store, 2).iter_batches(4, np.random.default_rng(0)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = step_draws(torch.Generator().manual_seed(1), cfg, 4, "cpu")
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


def stage_split(models, cfg, state, batch, gen, reps=3) -> dict:
    """Wall ms of the step's stages, each synchronised: heat prep, forward
    and loss (without the heat prep it contains), backward, optimizer."""
    from gabril_carla_tpu_torch.train.bc import bc_loss_fn

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    wall = dict.fromkeys(("heat prep", "forward and loss", "backward", "optimizer"), 0.0)
    for _ in range(reps):
        _, t_heat = timed(lambda: models.heatmapper.prepare_for_bc(
            batch["obs_seq"], batch["gaze_seq"], frame_stack=cfg.data["frame_stack"],
            grayscale=cfg.model["grayscale"]))
        live = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        (loss, _), t_fwd = timed(lambda: bc_loss_fn(live, models, cfg, batch, gen))
        grads, t_bwd = timed(lambda: torch.autograd.grad(loss, list(live.values())))
        _, t_opt = timed(lambda: state.apply_gradients(dict(zip(live, grads))))
        for k, t in zip(wall, (t_heat, t_fwd - t_heat, t_bwd, t_opt)):
            wall[k] += t / reps
    return wall


def train_phase(card: str) -> dict:
    """Phase 7: the train step at bench_train.py's configuration."""
    from torch.utils.flop_counter import FlopCounterMode

    from gabril_carla_tpu_torch.train.bc import init_bc_state, make_bc_train_step
    from gabril_carla_tpu_torch.train.optim import build_optimizer

    cfg = bench_train_cfg()
    tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=100)
    models, state0 = init_bc_state(cfg, torch.Generator(device="cuda").manual_seed(0), tx)
    step = make_bc_train_step(models, cfg)
    batch = bench_batch(cfg, TRAIN_BATCH, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state0, batch, gen)  # warm-up
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch, gen)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    vals = {k: float(v) for k, v in metrics.items()}
    groups = sorted({k.split(".")[0] for k in state.params})
    moved = {g: any(not torch.equal(state.params[k], state0.params[k])
                    for k in state.params if k.startswith(g + ".")) for g in groups}
    finite = all(math.isfinite(v) for v in vals.values()) and all(
        bool(torch.isfinite(v).all()) for v in state.params.values())
    log(f"[train] bench_train.py's step (batch {TRAIN_BATCH}, Reg, bf16, full width): first step "
        f"{first_ms:.1f} ms; {TRAIN_STEPS} steps {step_ms:.3f} ms each, "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} samples/s; peak memory {peak / 2**30:.2f} GiB; on {card}")
    log(f"[train] metrics after {state.step} steps: " + ", ".join(f"{k} {v:.5f}" for k, v in vals.items())
        + "; parameter groups moved: " + ", ".join(f"{g} {m}" for g, m in moved.items()))
    if not finite or vals["loss_reg"] <= 0 or not all(moved.values()):
        raise SystemExit("chip_smoke: the train step gave non-finite results, loss_reg <= 0 or "
                         "left a parameter group unchanged")

    with FlopCounterMode(display=False) as counter:
        step(state, batch, gen)
    flops = counter.get_total_flops()
    bound_ms = flops / PEAK_BF16_S * 1e3
    log(f"[train] FLOPs per step {flops / 1e12:.3f} T (FlopCounterMode; counted from the shapes "
        f"{FLOPS_COUNTED / 1e12:.2f} T); at the {PEAK_BF16_S / 1e12:.0f} TFLOP/s bf16 peak "
        f"{bound_ms:.2f} ms, so the step runs at {100 * bound_ms / step_ms:.1f}% of it")
    stages = stage_split(models, cfg, state, batch, gen)
    log("[train] stage split, wall ms each synchronised: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    busy, span = profile_window("train", "3 steps", lambda: [step(state, batch, gen) for _ in range(3)])

    torch.backends.cudnn.benchmark = True
    try:
        for _ in range(2):
            step(state, batch, gen)
        start.record()
        for _ in range(10):
            step(state, batch, gen)
        end.record()
        torch.cuda.synchronize()
        bench_ms = start.elapsed_time(end) / 10
    finally:
        torch.backends.cudnn.benchmark = False
    log(f"[train] with cudnn.benchmark on: {bench_ms:.3f} ms a step "
        f"({TRAIN_BATCH / bench_ms * 1e3:.1f} samples/s)")
    return {"samples_per_s": TRAIN_BATCH / step_ms * 1e3, "step_ms": step_ms, "first_step_ms": first_ms,
            "flops_per_step": flops, "flops_counted": FLOPS_COUNTED,
            "bf16_peak_share": bound_ms / step_ms, "peak_mem_gib": peak / 2**30,
            "device_busy_share": busy / span, "stages_ms": stages,
            "cudnn_benchmark_step_ms": bench_ms, "card": card}


def methods_phase():
    """Phase 8: every method on the card against the CPU, then one bf16
    full-width step of each."""
    import numpy as np

    from gabril_carla_tpu_torch.train.bc import (DROPOUT_METHODS, GAZE_METHODS, init_bc_state,
                                                 make_bc_train_step)
    from gabril_carla_tpu_torch.train.optim import build_optimizer

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
            models, state = init_bc_state(cfg, torch.Generator(device="cuda").manual_seed(0), tx)
            new, metrics = make_bc_train_step(models, cfg)(
                state, bench_batch(cfg, 16, "cuda"), torch.Generator(device="cuda").manual_seed(1))
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

    out = {"card": card}
    for arch in ("autoencoder", "unet"):
        cfg = gaze_cfg(arch)
        tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=100)
        (model, hm), state0 = init_gaze_state(cfg, torch.Generator(device="cuda").manual_seed(0), tx)
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

    cases = {}
    for name, gaze, dropout in (("mask_predictor", "Mask", "None"), ("gmd_analytic", "None", "GMD"),
                                ("confounded", "None", "None")):
        cfg = default_bc_config()
        cfg["gaze"]["method"], cfg["dropout"]["method"] = gaze, dropout
        cfg["training"]["compute_dtype"] = "bfloat16"
        models = build_bc_models(cfg, dev)
        params = init_bc_params(models, cfg, torch.Generator(device=dev).manual_seed(0))
        params["actor.fc2.bias"][0] = THROTTLE_BIAS
        kw = {"gmd_analytic": dict(use_analytic_gaze=True),
              "confounded": dict(confounded=True)}.get(name, {})
        if name == "mask_predictor":
            gp, _ = build_gaze_models(gaze_cfg(), dev)
            gp_params = init_gaze_params(gp, torch.Generator(device=dev).manual_seed(5))
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

        make_rollout_fn(probe, cfg, steps=HEAT_TICKS, **kw)(
            spec, params, torch.Generator(device="cuda").manual_seed(2))
        rollout = make_rollout_fn(policy, cfg, steps=HEAT_TICKS, **kw)
        torch.cuda.synchronize()
        render_kernel.launches = 0
        t0 = time.perf_counter()
        state, trace = rollout(spec, params, torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = render_kernel.launches
        sc = compute_score(spec, state)["score_composed"]
        moved = (trace[-1] - trace[WARMUP_STEPS - 1]).norm(dim=-1)
        drove = float(moved.median()) > MOVED_M and bool((sc > 0).any())
        lo_hi = torch.stack(bounds).cpu() if bounds else None
        heat_ok = lo_hi is None or (float(lo_hi[:, 0].min()) >= 0.0 and float(lo_hi[:, 1].max()) <= 1.0)
        stages = stage_breakdown(spec, params, policy, cfg, kw)
        busy, span = profile_window(f"heat {name}", "10 ticks", lambda: make_rollout_fn(
            policy, cfg, steps=10, **kw)(spec, params, draws=tick_draws(b)))
        log(f"[heat] {name}: {b} worlds x {HEAT_TICKS} ticks in {dt:.3f} s, {b * HEAT_TICKS / dt:.1f} env "
            f"steps/s; render launches {launches} (want {HEAT_TICKS + 1}); heat in "
            + ("[%.4g, %.4g]" % (float(lo_hi[:, 0].min()), float(lo_hi[:, 1].max())) if lo_hi is not None
               else "(no heat: gaze None)")
            + f"; moved median {float(moved.median()):.3f} m, max {float(moved.max()):.3f} m; "
            f"score_composed mean {sc.mean().item():.4f}, > 0 in {int((sc > 0).sum())} worlds; on {card}")
        log(f"[heat] {name}: wall ms per tick, each stage synchronised: "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
        if launches != HEAT_TICKS + 1 or not heat_ok or not torch.isfinite(sc).all() \
                or not torch.isfinite(trace).all() or not drove:
            raise SystemExit(f"chip_smoke: heat rollout {name}: {launches} render launches (want "
                             f"{HEAT_TICKS + 1}), heat out of [0, 1], non-finite scores, or the "
                             f"median world moved no more than {MOVED_M} m or no score is above 0")
        max_err = max(max_err, kernel_vs_plain(f"heat rollout {name} at its final state",
                                               operands(spec, state)))
        out[name] = {"steps_per_s": b * HEAT_TICKS / dt, "wall_s": dt, "launches": launches,
                     "score_mean": sc.mean().item(), "worlds_scored": int((sc > 0).sum()),
                     "moved_median_m": float(moved.median()), "stages_ms": stages, "ticks": HEAT_TICKS,
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

    cfg = gaze_cfg(arch, 2, tiny=True)
    cpu, hm = build_gaze_models(cfg, "cpu")
    params = init_gaze_params(cpu, torch.Generator().manual_seed(0))
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

    cfg = vq_cfg(2, tiny=True)
    cpu = V.build_vqvae_models(cfg, "cpu")
    params = V.init_vqvae_params(cpu, torch.Generator().manual_seed(0))
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

    draws = V.revive_draws(torch.Generator().manual_seed(3), x.shape[0] * 20 * 38, 16, 4)
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

    cfg = vq_cfg()
    tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=100)
    model, state0 = init_vqvae_state(cfg, torch.Generator(device="cuda").manual_seed(0), tx)
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
    b_ms, b_by, full_ms = bound(ops)
    log(f"[time] render kernel at {N_WORLDS} worlds: {k_ms:.4f} ms; plain version {p_ms:.3f} ms; "
        f"bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / k_ms:.1f}% of the bound); full-loop bound "
        f"{full_ms:.4f} ms ({100 * full_ms / k_ms:.1f}%); on {card}")
    log("[time] no single PyTorch call computes this function: library_ms is null")

    # 6. where the time goes
    stages = stage_breakdown(spec, params, policy, cfg, {})
    log("[breakdown] wall ms per tick, each stage synchronised: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    profile_window("breakdown", "10 ticks", lambda: make_rollout_fn(policy, cfg, steps=10)(
        spec, params, draws=tick_draws(N_WORLDS)))
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
    log(f"[done] {time.perf_counter() - t_all:.1f} s in all")

    by_path = {"main": launches, **{f"heat {k}": v["launches"] for k, v in heat.items()},
               "eval_routes": eval_launches, "collect": collect_launches}
    print(json.dumps({"kernels": [{
        "name": "render", "route": "cuda", "source": "gabril_carla_tpu_torch/csrc/render.cu",
        "replaces": "gabril_carla_tpu/ops/pallas_raster.py:88", "launches": launches,
        "launches_by_path": by_path, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "bound_full_loop_ms": full_ms, "library_ms": None}]}))
    print(json.dumps({"train": train}))
    print(json.dumps({"gaze_train": gaze}))
    print(json.dumps({"heat_rollouts": heat}))
    print(json.dumps({"collect": collected}))
    print(json.dumps({"vqvae_train": vq}))
    print(json.dumps({"pipeline": pipeline}))
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
