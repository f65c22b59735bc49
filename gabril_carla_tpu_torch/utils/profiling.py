"""Profiling hooks (port of gabril_carla_tpu/utils/profiling.py): per-stage
wall timers, a torch.profiler trace in place of jax.profiler's, and the
reference's sim/wall ratio; beside them, the card's name and power limit
and a trace's device kernels, which the measuring entry points print.

A stage around device work measures the device only when it ends in a
synchronize; the Trainer's epoch stage ends in one (its metrics' copy to
the host).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_ms": round(1000 * v / max(1, self.counts[k]), 3)}
            for k, v in sorted(self.totals.items())
        }

    def report(self) -> str:
        return " | ".join(
            f"{k}: {s['mean_ms']:.1f}ms x{s['count']}" for k, s in self.summary().items()
        )


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Trace the block with torch.profiler (host activity, and the card's
    kernels when CUDA is available) and write it into ``log_dir`` as a
    Chrome trace, ``trace_<pid>_<ns>.json`` (Perfetto, chrome://tracing).
    Yields the profiler, or None when ``enabled`` is false."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_kernels(prof) -> dict:
    """{kernel name: (launches, device ms)} of a finished torch.profiler run."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sim_wall_ratio(sim_seconds: float, wall_seconds: float) -> float:
    """The reference's agent-side speed metric (autonomous_agent.py:143-151)."""
    return 0.0 if wall_seconds <= 0 else sim_seconds / wall_seconds
