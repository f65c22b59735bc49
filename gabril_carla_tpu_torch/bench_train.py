"""BC train-step samples/s and model-FLOPs utilization on one card (port of
the JAX repo's bench_train.py).

    python -m gabril_carla_tpu_torch.bench_train [bs] [iters] [--device cuda|cpu]

The train step at the reference's training configuration of record
(bench_train.py:62-65: batch ``bs``, method Reg, mask_sigma 30, bf16;
180x320 grayscale, frame stack 2, default widths), parameters from
``init_bc_state(cfg, prng_key(0), tx)`` with ``tx`` built for 100 steps an
epoch, and bench_train.py:74-81's batch drawn from
``np.random.default_rng(0)``, resident on the device. One warm-up step with
key ``prng_key(1)``, then ``iters`` timed steps with ``fold_in(prng_key(1),
i)`` on the host clock ending in a synchronize (bench_train.py:83-104).

FLOPs: ``flops_per_step`` is what ``torch.utils.flop_counter.FlopCounterMode``
counts over the warm-up step: the matmuls and convolutions of forward and
backward, two a multiply-add. The JAX script reads XLA's ``cost_analysis``
of the compiled step instead, which also counts elementwise work, so the
two scripts' FLOPs and MFU are not the same count. MFU is those FLOPs a
second over the card's dense bf16 peak (``PEAK_BF16``, by
``torch.cuda.get_device_name()``); an unknown card or the CPU gives
``mfu_pct: null``, as bench_train.py:107-109 does.

The last stdout line is bench_train.py:110-117's JSON: ``{"metric",
"value", "unit", "vs_baseline", "mfu_pct", "flops_per_step", "step_ms",
"mode"}``. stderr gets the card's name and power limit, the CUDA-event
step time, peak memory and the final metrics. Without a card it exits
non-zero and prints no JSON unless ``--device cpu`` is given (for tests:
its rate is the CPU's).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from .train.bc import init_bc_state, make_bc_train_step
from .train.optim import build_optimizer
from .utils.config import default_bc_config
from .utils.prng import fold_in, prng_key
from .utils.profiling import card_line

# dense bf16 FLOP/s by torch.cuda.get_device_name(): the H100 SXM's data sheet
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}
BATCH, ITERS = 2000, 30  # bench_train.py:57-58
KEY = prng_key(1)  # bench_train.py:83


def bench_train_cfg(batch_size: int = BATCH):
    """bench_train.py's configuration: the defaults (full width, 180x320
    grayscale, frame stack 2) with Reg, mask_sigma 30 and bf16."""
    cfg = default_bc_config()
    cfg["data"]["batch_size"] = batch_size
    cfg["gaze"].update(method="Reg", mask_sigma=30.0)
    cfg["training"]["compute_dtype"] = "bfloat16"
    return cfg


def bench_batch(cfg, batch_size: int, device, seed: int = 0) -> dict:
    """A batch made as bench_train.py:74-81 makes it, from numpy ``seed``:
    uint8 obs [bs, S, H, W, 1], gaze [bs, S, 2P], actions [bs, A]."""
    s, p = cfg.data["frame_stack"], cfg.gaze["max_points"]
    h, w = cfg.data["img_height"], cfg.data["img_width"]
    host = np.random.default_rng(seed)
    batch = {"obs_seq": host.integers(0, 255, (batch_size, s, h, w, 1), dtype=np.uint8),
             "gaze_seq": host.random((batch_size, s, p * 2), dtype=np.float32),
             "actions": host.random((batch_size, cfg.data["action_dim"]), dtype=np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def bench_train_state(cfg, device):
    """(models, TrainState) as bench_train.py:67-70 makes them: the
    optimizer built for 100 steps an epoch, parameters from prng_key(0)."""
    tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=100)
    return init_bc_state(cfg, prng_key(0), tx, device=device)


def timed_keys(iters: int) -> list[np.ndarray]:
    """The timed steps' keys: ``fold_in(prng_key(1), i)``."""
    return [fold_in(KEY, i) for i in range(iters)]


def _log(msg: str):
    print(f"bench_train: {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m gabril_carla_tpu_torch.bench_train",
                                description="BC train-step samples/s and MFU on one card")
    p.add_argument("bs", type=int, nargs="?", default=BATCH)
    p.add_argument("iters", type=int, nargs="?", default=ITERS)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    args = parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        _log("no CUDA device (--device cpu runs the step on the CPU)")
        return 1
    bs, iters = args.bs, args.iters
    if cuda:
        _log(card_line())

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = bench_train_cfg(bs)
    models, state = bench_train_state(cfg, args.device)
    step = make_bc_train_step(models, cfg)
    batch = bench_batch(cfg, bs, args.device)
    keys = timed_keys(iters)

    with FlopCounterMode(display=False) as counter:
        state, _ = step(state, batch, KEY)  # warm-up
    sync()
    flops = float(counter.get_total_flops())

    if cuda:
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for key in keys:
        state, metrics = step(state, batch, key)
    if cuda:
        end.record()
    sync()
    dt = time.perf_counter() - t0

    vals = {k: float(v) for k, v in metrics.items()}
    _log("metrics after the timed steps: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    if cuda:
        _log(f"{iters} steps {1e3 * dt / iters:.3f} ms each on the host clock, "
             f"{start.elapsed_time(end) / iters:.3f} ms between CUDA events; "
             f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for v in vals.values()):
        _log("the train step gave non-finite metrics")
        return 1

    peak = PEAK_BF16.get(name) if cuda else None
    mfu = flops * iters / dt / peak * 100.0 if peak else None
    print(json.dumps({
        "metric": "train_samples_per_sec_per_chip",
        "value": round(bs * iters / dt, 1),
        "unit": "samples/s",
        "vs_baseline": None,  # the reference publishes no training throughput
        "mfu_pct": round(mfu, 1) if mfu is not None else None,
        "flops_per_step": flops,
        "step_ms": round(dt / iters * 1e3, 2),
        "mode": f"bs{bs}_bf16_Reg_{name.replace(' ', '_')}",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
