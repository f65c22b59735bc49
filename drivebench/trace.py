"""The traced stretch: torch.profiler over a few steady steps or ticks,
read back from its Chrome trace.

Each device operation (kernel, copy, fill) is tied to the host call that
launched it by the trace's correlation ids, and so to the harness span
(``drivebench.<stage>``, a torch.profiler.record_function around the
program's call) that was open at the launch. The reading gives the
device's busy seconds (the union of its operations' intervals), the
stretch's length on the host clock, device time by span and by kernel name,
kernel launches, and the longest idle gaps with the host call that ran
longest beside each.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict

from .common import SPAN, sync, tmp_dir

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
NO_HOST_OP = "_no_traced_host_op_"


class Stretch:
    """Start and stop torch.profiler around a stretch of ``units`` steps or
    ticks, each end synchronized, and keep the host clock's length."""

    def __init__(self, device, units: int):
        self.device = device
        self.units = units
        self.prof = None
        self.window_s = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        sync(self.device)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def read(self) -> "TraceReading":
        path = tmp_dir() / f"drivebench_trace_{os.getpid()}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        try:
            self.prof.export_chrome_trace(str(path))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        self.prof = None
        return TraceReading(events, self.window_s, self.units)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceReading:
    """What the metrics read from one traced stretch (all times in s)."""

    def __init__(self, events, window_s: float, units: int):
        self.window_s = window_s
        self.units = units
        xs = [e for e in events if e.get("ph") == "X"]
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in dev if e["cat"] == "kernel"]
        launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                     if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN):]) for e in xs
                       if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN))
        starts = [s[0] for s in spans]

        def span_of(ts):
            i = bisect.bisect_right(starts, ts) - 1
            return spans[i][2] if i >= 0 and ts <= spans[i][1] else None

        self.span_s = defaultdict(float)
        self.kernel_s = defaultdict(float)
        for e in dev:
            dur = e["dur"] * 1e-6
            self.kernel_s[e["name"]] += dur
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            name = span_of(ts) if ts is not None else None
            if name is not None:
                self.span_s[name] += dur
        busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in dev)
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        host = [e for e in xs if e.get("cat") in HOST_CATS]
        gaps = [(s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0]
        gaps.sort(reverse=True)
        self.idle_gaps = []
        for length, g0, g1 in gaps[:10]:
            best, name = 0.0, NO_HOST_OP
            for e in host:
                ov = min(g1, e["ts"] + e["dur"]) - max(g0, e["ts"])
                if ov > best:
                    best, name = ov, e["name"]
            self.idle_gaps.append([name, length * 1e-6])

    def kernel_time(self, needle: str) -> tuple[int, float]:
        """(launches, device s) of the kernels whose name holds ``needle``."""
        ks = [e for e in self.kernels if needle in e["name"]]
        return len(ks), sum(e["dur"] for e in ks) * 1e-6

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": self.idle_gaps}
