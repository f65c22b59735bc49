"""Profiling hooks (port of gabril_carla_tpu/utils/profiling.py): per-stage
wall timers, a torch.profiler trace in place of jax.profiler's, and spans
at the port's layer boundaries that land in that trace; beside them, the
card's name and power limit and a trace's device kernels, which the
measuring entry points print.

A stage around device work measures the device only when it ends in a
synchronize; the Trainer's epoch stage ends in one (its metrics' copy to
the host).

Spans. ``with span("rollout.render"): ...`` marks one stage. While no
torch.profiler session runs it costs one flag check. While one runs, it
opens a ``record_function`` of its name (so it sits in the Chrome trace on
the device's timeline), stamps its host start and end with
``time.time_ns()`` (the trace's clock: an event's ``ts`` +
``baseTimeNanoseconds`` / 1e3 is its start in microseconds), and, once CUDA
is initialized, records a CUDA event on the current stream at each end,
without a synchronize (the events come from a pool: a fresh record hands
the old record's events to later spans). ``span_summary()`` gives each
name's count, host ms and stream ms (the time the card's stream took from
one event to the other: the span's kernels and the device idle that waits
on its launches), each also as self time, without what the span's
children cover. Spans of one thread nest; the names the port opens:

  rollout.call > rollout.draws, rollout.reset, rollout.tick
  rollout.tick > rollout.render, rollout.ring, rollout.heat, rollout.policy,
                 rollout.overlay (confounded), rollout.noop, rollout.env_step
  train.step   > train.draws (BC), train.forward > train.heat_prep,
                 train.backward, train.allreduce (with a group), train.optimizer
  trainer.<stage> (StageTimer) around the Trainer's stages
  collect.tick > collect.render, collect.expert, collect.env_step,
                 label.vision, label.prefill, label.decode (with a labeler)
  label.prefill, label.decode > label.moe (each expert layer)

The launch counters are read where their kernel's module is loaded: a span
never imports one. Beside them, ``tally(name, n)`` adds to a counter of
its own while a profiler session runs (the VLM labeler's tokens, routed
pairs, heaviest expert loads and experts that got any pair); a tensor
stays on its device until ``span_summary`` reads it.

A span is kept when the profiler ran at its open and at its close and its
parent was kept. A span whose parent opened before the session began is
kept as a root, unless its name is found under a parent elsewhere in the
record: then it is what is left of a span the session's start cut, and it
goes with its children. So a tick cut by either end of a profiled stretch
is dropped whole, and the ticks inside it are kept. ``profile_trace``
starts a fresh record, as does the first span opened after one saw the
profiler stop; around a bare torch.profiler session, ``reset_spans()``
first.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

PORT_SPANS = ("rollout.", "train.", "trainer.", "collect.", "label.")  # prefixes of the spans the port opens
NO_SPAN = "(no port span)"  # idle_by_span's key for idle outside every port span
_OFF = contextlib.nullcontext()


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"trainer.{name}"):
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


class _Record:
    """The spans closed while a profiler session ran, in closing order."""

    def __init__(self):
        self.spans: list[_Span] = []
        self.stack: list[_Span] = []
        self.stale = True  # the next span opened while profiling starts a fresh record
        self.free: list = []  # CUDA events of dropped records, recorded again by later spans
        self.counters0: list[int] = []
        self.counters1: list[int] = []
        self.tallies: dict = {}


_REC = _Record()
_PKG = __name__.rsplit(".", 2)[0]
# (span_summary's counter name, module, kernel object): read where the module is loaded, so that a
# span never imports one; a kernel not loaded yet has launched nothing
_COUNTERS = (("render_kernel_launches", f"{_PKG}.ops.render_kernel", "render_kernel"),
             ("threefry_kernel_launches", f"{_PKG}.ops.threefry_kernel", "threefry_kernel"),
             ("unet_kernel_launches", f"{_PKG}.ops.unet_kernel", "unet_kernel"))


def _launches() -> list[int]:
    mods = [sys.modules.get(mod) for _, mod, _ in _COUNTERS]
    return [0 if m is None else getattr(m, obj).launches for m, (_, _, obj) in zip(mods, _COUNTERS)]


def reset_spans():
    """Start a fresh span record; the old record's CUDA events go back to
    the pool that later spans record again."""
    _REC.free += [e for s in _REC.spans if s.e0 is not None for e in (s.e0, s.e1)]
    _REC.spans, _REC.stack, _REC.stale = [], [], False
    _REC.counters0 = _REC.counters1 = _launches()
    _REC.tallies = {}


def tally(name: str, n):
    """Add ``n`` (an int, or a tensor summed where it lies, without a
    synchronize) to the counter ``name`` of the current record while a
    profiler session runs; otherwise nothing."""
    if _autograd_profiler._is_profiler_enabled:
        if _REC.stale:
            reset_spans()
        _REC.tallies[name] = _REC.tallies.get(name, 0) + n


def _event():
    """A CUDA event recorded on the current stream, from the pool when it
    holds one (creating and destroying events costs more than recording)."""
    e = _REC.free.pop() if _REC.free else torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Span:
    __slots__ = ("name", "parent", "closed", "t0", "t1", "e0", "e1", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _REC.stale:
            reset_spans()
        self.parent = _REC.stack[-1] if _REC.stack else None
        self.closed = False
        _REC.stack.append(self)
        self.rf = _autograd_profiler.record_function(self.name)
        self.rf.__enter__()
        self.e0 = self.e1 = None
        if torch.cuda.is_initialized():
            self.e0 = _event()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.e0 is not None:
            self.e1 = _event()
        self.rf.__exit__(*exc)
        if _REC.stack and _REC.stack[-1] is self:
            _REC.stack.pop()
        if _autograd_profiler._is_profiler_enabled:
            self.closed = True
            _REC.spans.append(self)
            _REC.counters1 = _launches()
        else:
            _REC.stale = True
        return False


def span(name: str):
    """A context manager marking one stage as the span ``name`` (module
    docstring); while no profiler session runs, a no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def _kept() -> list[_Span]:
    """The record's kept spans, in closing order."""
    good = {}

    def ok(s):  # closed while profiling, and so was every recorded ancestor
        if id(s) not in good:
            good[id(s)] = s.closed and (s.parent is None or ok(s.parent))
        return good[id(s)]

    def root(s):
        while s.parent is not None:
            s = s.parent
        return s

    spans = [s for s in _REC.spans if ok(s)]
    nested = {s.name for s in spans if s.parent is not None}
    return [s for s in spans if root(s).name not in nested]


def span_records() -> list[dict]:
    """The kept spans in closing order: name, parent (an index into this
    list, or None), host start and end (ns, ``time.time_ns``) and stream ms
    (None without CUDA events). Resolving the events needs them done: call
    after a synchronize."""
    spans = _kept()
    index = {id(s): i for i, s in enumerate(spans)}
    return [{"name": s.name, "parent": index.get(id(s.parent)), "host_start_ns": s.t0,
             "host_end_ns": s.t1, "stream_ms": None if s.e0 is None else s.e0.elapsed_time(s.e1)}
            for s in spans]


def span_summary() -> dict:
    """{"spans": {name: {count, host_ms, host_self_ms, stream_ms,
    stream_self_ms}}, "counters": {render_kernel_launches,
    threefry_kernel_launches, unet_kernel_launches, and each tally}} over
    the kept spans: totals over each name's spans, self time without what
    their children cover, stream times None without CUDA events; the
    launch counters are the launches from the record's start to its last
    kept span's close, a tally its sum since the record's start.
    Synchronizes the card first."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    recs = span_records()
    child = [[0.0, 0.0] for _ in recs]
    for r in recs:
        if r["parent"] is not None:
            child[r["parent"]][0] += (r["host_end_ns"] - r["host_start_ns"]) / 1e6
            child[r["parent"]][1] += r["stream_ms"] or 0.0
    out = {}
    for r, (host_child, stream_child) in zip(recs, child):
        host = (r["host_end_ns"] - r["host_start_ns"]) / 1e6
        s = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                                       "stream_ms": None, "stream_self_ms": None})
        s["count"] += 1
        s["host_ms"] += host
        s["host_self_ms"] += host - host_child
        if r["stream_ms"] is not None:
            s["stream_ms"] = (s["stream_ms"] or 0.0) + r["stream_ms"]
            s["stream_self_ms"] = (s["stream_self_ms"] or 0.0) + r["stream_ms"] - stream_child
    counters = {name: b - a for (name, _, _), a, b in zip(_COUNTERS, _REC.counters0, _REC.counters1)}
    counters.update({k: int(v) for k, v in _REC.tallies.items()})
    return {"spans": out, "counters": counters}


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Trace the block with torch.profiler (host activity, and the card's
    kernels when CUDA is available) and write it into ``log_dir`` as a
    Chrome trace, ``trace_<pid>_<ns>.json`` (Perfetto, chrome://tracing),
    whose path the profiler carries as ``trace_path`` after the block. The
    block's spans start a fresh record. Yields the profiler, or None when
    ``enabled`` is false."""
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
    reset_spans()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = str(out / f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def idle_by_span(trace_path: str) -> dict[str, float]:
    """Device idle ms of a Chrome trace (``profile_trace``'s) by the
    innermost port span the host was in while it passed: between the
    first device operation's start and the last one's end, every stretch
    in which no kernel, copy or fill runs goes to the span open on the
    host then, or to ``NO_SPAN``. Largest first."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    busy = []
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    idle = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith(PORT_SPANS)),
                   key=lambda x: (x[0], -x[1]))
    # the innermost span at each host instant, as [start, end, name] pieces in time order
    pieces, stack, t = [], [], float("-inf")
    for s, e, name in spans + [(float("inf"), float("inf"), None)]:
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            if end > t:
                pieces.append((t, end, inner))
                t = end
        if stack and s > t:
            pieces.append((t, s, stack[-1][1]))
        t = max(t, s)
        stack.append((e, name))
    starts = [p[0] for p in pieces]
    out = defaultdict(float)
    for a, b in idle:
        left = b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            ov = min(b, pieces[i][1]) - max(a, pieces[i][0])
            if ov > 0:
                out[pieces[i][2]] += ov / 1e3
                left -= ov
            i += 1
        if left > 0:
            out[NO_SPAN] += left / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def device_kernels(prof) -> dict:
    """{kernel name: (launches, device ms)} of a finished torch.profiler run;
    a span's range on the device's timeline is no kernel."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            n, ms = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
