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
     temporary directory, ending with a finite loss, ep2 and params.json.
Prints a JSON line of kernel records, a JSON line of the train step's
numbers, the card line, and last {"ok": true, "device": {...}}. Exits
non-zero without them when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

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
LOSS_RTOL, GRAD_FRAC = 1e-4, 1e-3  # phase 8: card against CPU


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


def breakdown(spec, params, policy, cfg, ticks=10):
    """Where a tick's time goes at the main path's batch: the wall time of
    each stage, synchronised around it, then a profiler window over a short
    rollout: the device's busy share and the kernels that fill it."""
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
    profile_window("breakdown", f"{ticks} ticks", lambda: rollout(spec, params, draws=draws))


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
    breakdown(spec, params, policy, cfg)

    # 7-9. BC training
    train = train_phase(card)
    methods_phase()
    trainer_phase()
    log(f"[done] {time.perf_counter() - t_all:.1f} s in all")

    print(json.dumps({"kernels": [{
        "name": "render", "route": "cuda", "source": "gabril_carla_tpu_torch/csrc/render.cu",
        "replaces": "gabril_carla_tpu/ops/pallas_raster.py:88", "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "bound_full_loop_ms": full_ms, "library_ms": None}]}))
    print(json.dumps({"train": train}))
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
    sys.exit(main())
