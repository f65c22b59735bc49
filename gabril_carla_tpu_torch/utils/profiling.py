"""Per-stage wall timers (port of gabril_carla_tpu/utils/profiling.py:
StageTimer). A stage around device work measures the device only when it
ends in a synchronize; the Trainer's epoch stage ends in one (its metrics'
copy to the host)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


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
