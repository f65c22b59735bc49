"""Spans inside the port (utils/profiling.py: span, span_records,
span_summary, idle_by_span) on the CPU.

With no profiler running a span keeps nothing and a rollout's outputs are
bitwise those of a traced one. A 3-world x 4-tick rollout under
profile_trace records one rollout.call holding its draws, reset and four
ticks, each tick holding its stages; a stretch whose ends cut ticks keeps
only the whole ones; the BC and UNet train steps nest heat prep in the
forward, then the backward and the optimizer. Host stamps lie on the
Chrome trace's clock; idle_by_span splits a synthetic trace's idle by the
innermost span. A span's CUDA events come from a pool that each fresh
record refills, and no span imports a kernel module to read its launch
counter. The nine span metrics under drivebench/metrics/ read None here (no
stream) and their per-tick or per-step value from a summary that has
stream times.
"""

import contextlib
import dataclasses
import gc
import json
import sys
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from drivebench import common as bench_common
from gabril_carla_tpu_torch.data.tasks import seen_routes
from gabril_carla_tpu_torch.env.world import load_benchmark_specs, to_torch
from gabril_carla_tpu_torch.eval import rollout as RO
from gabril_carla_tpu_torch.train.bc import build_bc_models, init_bc_params, make_bc_policy_fn, make_bc_train_step
from gabril_carla_tpu_torch.train.gaze_predictor import build_gaze_models, init_gaze_params, make_gaze_train_step
from gabril_carla_tpu_torch.train.optim import TrainState, build_optimizer
from gabril_carla_tpu_torch.utils import profiling as P
from gabril_carla_tpu_torch.utils.config import default_bc_config, default_gaze_config
from gabril_carla_tpu_torch.utils.prng import prng_key, split
from test_torch_common import cpu_threads

WORLDS, TICKS = 3, 4
STAGES = {"None": ["rollout.render", "rollout.ring", "rollout.policy", "rollout.noop", "rollout.env_step"],
          "Mask": ["rollout.render", "rollout.ring", "rollout.heat", "rollout.policy", "rollout.noop",
                   "rollout.env_step"],
          "confounded": ["rollout.render", "rollout.ring", "rollout.heat", "rollout.policy", "rollout.overlay",
                         "rollout.heat", "rollout.policy", "rollout.noop", "rollout.env_step"]}
EVAL_METRICS = {"render_stream_ms_per_tick": "rollout.render", "policy_stream_ms_per_tick": "rollout.policy",
                "env_step_stream_ms_per_tick": "rollout.env_step", "heat_stream_ms_per_tick": "rollout.heat",
                "glue_stream_ms_per_tick": None}
TRAIN_METRICS = {"heat_prep_stream_ms_per_step": "train.heat_prep", "forward_stream_ms_per_step": "train.forward",
                 "backward_stream_ms_per_step": "train.backward",
                 "optimizer_stream_ms_per_step": "train.optimizer"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def rollout_fn(variant: str):
    cfg = default_bc_config()
    cfg["gaze"]["method"] = "None" if variant == "None" else "Mask"
    cfg["training"]["compute_dtype"] = "float32"
    cfg["model"].update(num_hiddens=8, embedding_dim=8, z_dim=16, num_residual_hiddens=4)
    models = build_bc_models(cfg, "cpu")
    params = init_bc_params(models, cfg, prng_key(0))
    fn = RO.make_rollout_fn(make_bc_policy_fn(models, cfg), cfg, steps=TICKS,
                            use_analytic_gaze=variant != "None", confounded=variant == "confounded")
    spec = to_torch(load_benchmark_specs(seen_routes()[:WORLDS]), "cpu")
    return lambda: fn(spec, params, split(prng_key(3), WORLDS))


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """variant -> (outputs, span records, Chrome trace path) of one traced
    rollout, run once a module."""
    runs = {}

    def get(variant):
        if variant not in runs:
            run = rollout_fn(variant)
            # a full collection between record_function's clock read and the span's own takes
            # milliseconds in a test process that holds many objects; the stamps' test needs
            # the two reads adjacent, so the collector waits out the traced call
            gc.disable()
            try:
                with P.profile_trace(str(tmp_path_factory.mktemp(variant))) as prof:
                    out = run()
            finally:
                gc.enable()
            runs[variant] = (out, P.span_records(), prof.trace_path)
        return runs[variant]

    return get


def children(recs, i):
    return [r["name"] for r in recs if r["parent"] == i]


def leaves(obj):
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple):
        return [x for o in obj for x in leaves(o)]
    return [x for f in dataclasses.fields(obj) for x in leaves(getattr(obj, f.name))]


def test_span_off_records_nothing():
    P.reset_spans()
    assert not autograd_profiler._is_profiler_enabled
    off = P.span("rollout.tick")
    with off, P.span("rollout.render"):
        torch.ones(3).sum()
    assert isinstance(off, contextlib.nullcontext) and off is P.span("train.step")
    assert P.span_records() == [] and P.span_summary()["spans"] == {}


def test_rollout_outputs_unchanged_by_tracing(traced):
    plain = rollout_fn("Mask")()
    got = traced("Mask")[0]
    assert all(torch.equal(a, b) for a, b in zip(leaves(plain), leaves(got), strict=True))


@pytest.mark.parametrize("variant", list(STAGES))
def test_traced_rollout_nests_stages(traced, variant):
    recs = traced(variant)[1]
    roots = [i for i, r in enumerate(recs) if r["parent"] is None]
    assert [recs[i]["name"] for i in roots] == ["rollout.call"]
    assert children(recs, roots[0]) == ["rollout.draws", "rollout.reset"] + ["rollout.tick"] * TICKS
    ticks = [i for i, r in enumerate(recs) if r["name"] == "rollout.tick"]
    for i in ticks:
        assert children(recs, i) == STAGES[variant]
    assert all(r["stream_ms"] is None for r in recs)  # no CUDA events on the CPU


@pytest.mark.parametrize("stop_tick", [None, 3])
def test_ticks_cut_by_the_stretch_are_dropped(monkeypatch, stop_tick):
    """The profiler starts inside tick 1's render (as drivebench's stretch
    does) and stops inside tick ``stop_tick``'s render, or after the call."""
    run = rollout_fn("Mask")
    prof = profile(activities=[ProfilerActivity.CPU])
    calls = []
    real = RO.render_frame

    def render_frame(*a, **kw):
        calls.append(None)
        tick = len(calls) - 2  # the first call renders the reset's frame
        if tick == 1:
            P.reset_spans()
            prof.start()
        if tick == stop_tick:
            prof.stop()
        return real(*a, **kw)

    monkeypatch.setattr(RO, "render_frame", render_frame)
    run()
    if stop_tick is None:
        prof.stop()
    recs = P.span_records()
    kept = 1 if stop_tick == 3 else 2
    ticks = [i for i, r in enumerate(recs) if r["name"] == "rollout.tick"]
    assert len(ticks) == kept and all(recs[i]["parent"] is None for i in ticks)
    assert all(children(recs, i) == STAGES["Mask"] for i in ticks)
    assert len(recs) == kept * (1 + len(STAGES["Mask"]))
    assert P.span_summary()["spans"]["rollout.heat"]["count"] == kept


def bc_step():
    cfg = default_bc_config()
    cfg["data"].update(img_height=24, img_width=48, batch_size=4)
    cfg["model"].update(embedding_dim=8, num_hiddens=16, num_residual_layers=1, num_residual_hiddens=8,
                        z_dim=16)
    cfg["gaze"].update(method="Reg", max_points=3, mask_sigma=4.0)
    cfg["training"]["compute_dtype"] = "float32"
    cfg["scheduler"]["type"] = "none"
    models = build_bc_models(cfg, "cpu")
    params = init_bc_params(models, cfg, prng_key(0))
    return cfg, make_bc_train_step(models, cfg), params


def gaze_step():
    cfg = default_gaze_config()
    cfg["data"].update(img_height=180, img_width=320, frame_stack=2, batch_size=2, task="Gaze")
    cfg["model"].update(embedding_dim=4, num_hiddens=8, num_residual_layers=1, num_residual_hiddens=4,
                        z_dim=16, arch="unet")
    cfg["training"]["compute_dtype"] = "float32"
    cfg["scheduler"]["type"] = "none"
    model, heatmapper = build_gaze_models(cfg, "cpu")
    return cfg, make_gaze_train_step(model, heatmapper, cfg), init_gaze_params(model, cfg, prng_key(0))


def train_batch(cfg, n):
    g = torch.Generator().manual_seed(0)
    d, p = cfg["data"], cfg["gaze"]["max_points"]
    return {"obs_seq": torch.randint(0, 256, (n, d["frame_stack"], d["img_height"], d["img_width"], 1),
                                     generator=g, dtype=torch.uint8),
            "gaze_seq": torch.rand((n, d["frame_stack"], 2 * p), generator=g),
            "actions": torch.rand((n, d["action_dim"]), generator=g)}


@pytest.mark.parametrize("kind", ["bc", "gaze"])
def test_train_step_nests_phases(tmp_path, kind):
    cfg, step, params = bc_step() if kind == "bc" else gaze_step()
    state = TrainState.create(params, build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, 1))
    batch = train_batch(cfg, cfg["data"]["batch_size"])
    with P.profile_trace(str(tmp_path)):
        for _ in range(2):
            state, _ = step(state, batch, prng_key(1))
    recs = P.span_records()
    steps = [i for i, r in enumerate(recs) if r["parent"] is None]
    assert [recs[i]["name"] for i in steps] == ["train.step"] * 2
    phases = ["train.forward", "train.backward", "train.optimizer"]
    for i in steps:
        assert children(recs, i) == (["train.draws"] if kind == "bc" else []) + phases
        forward = next(j for j, r in enumerate(recs) if r["parent"] == i and r["name"] == "train.forward")
        assert children(recs, forward) == ["train.heat_prep"]
    summary = P.span_summary()["spans"]
    assert summary["train.forward"]["host_self_ms"] < summary["train.forward"]["host_ms"]


def test_span_stamps_lie_on_the_trace_clock(traced):
    _, recs, path = traced("confounded")
    trace = json.loads(open(path).read())
    base = trace["baseTimeNanoseconds"] / 1e3
    events = sorted((e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"
                     and e["name"].startswith(P.PORT_SPANS)), key=lambda e: e["ts"])
    ours = sorted(recs, key=lambda r: r["host_start_ns"])
    assert [e["name"] for e in events] == [r["name"] for r in ours]
    for e, r in zip(events, ours):
        assert abs(r["host_start_ns"] / 1e3 - (e["ts"] + base)) < 1e3
        assert abs(r["host_end_ns"] / 1e3 - (e["ts"] + e["dur"] + base)) < 1e3


def test_idle_by_span_on_a_synthetic_trace(tmp_path):
    """rollout.tick [0, 100] us holds rollout.render [10, 40]; kernels at
    [0, 10], [45, 60] and [90, 100], a copy at [95, 120] after the tick:
    idle [10, 45] and [60, 90]."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "rollout.tick", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "rollout.render", "ts": 10, "dur": 30},
          {"ph": "X", "cat": "user_annotation", "name": "drivebench.render", "ts": 10, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 45, "dur": 15},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 90, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 95, "dur": 25},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 50, "dur": 5}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev, "baseTimeNanoseconds": 0}))
    got = P.idle_by_span(str(path))
    assert got == pytest.approx({"rollout.tick": 0.035, "rollout.render": 0.030})
    ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": 150, "dur": 10})  # idle [120, 150] outside
    path.write_text(json.dumps({"traceEvents": ev}))
    got = P.idle_by_span(str(path))
    assert got == pytest.approx({"rollout.tick": 0.035, P.NO_SPAN: 0.030, "rollout.render": 0.030})
    assert list(got)[0] == "rollout.tick"


def test_profile_trace_starts_a_fresh_record(tmp_path):
    for i in range(2):
        with P.profile_trace(str(tmp_path / str(i))), P.span("train.step"):
            with P.span("train.optimizer"):
                torch.ones(2).sum()
    assert [r["name"] for r in P.span_records()] == ["train.optimizer", "train.step"]
    assert P.span_summary()["counters"] == {"render_kernel_launches": 0, "threefry_kernel_launches": 0,
                                            "unet_kernel_launches": 0}


def test_span_events_come_from_the_pool(monkeypatch, tmp_path):
    """A span records pooled CUDA events: a record's events are recorded
    again by the spans of the next record, and only what the pool lacks is
    created. Here with stand-in events (no card)."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.records = 0
            made.append(self)

        def record(self):
            self.records += 1

        def elapsed_time(self, end):
            return 2.0

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(P._REC, "free", [])
    for i, n in enumerate((3, 3, 4)):  # spans a record
        with P.profile_trace(str(tmp_path / str(i))), P.span("train.step"):
            for _ in range(n - 1):
                with P.span("train.backward"):
                    pass
        events = [e for s in P._REC.spans for e in (s.e0, s.e1)]
        assert len(set(map(id, events))) == 2 * n  # no event twice in one record
        assert P.span_summary()["spans"]["train.backward"]["stream_ms"] == 2.0 * (n - 1)
    assert len(made) == 8 and sum(e.records for e in made) == 2 * (3 + 3 + 4)


def test_span_never_imports_a_kernel_module(monkeypatch, tmp_path):
    """The launch counters read only loaded kernel modules: a span opened
    while the render kernel's module is not loaded leaves it unloaded and
    counts its launches as none."""
    name = "gabril_carla_tpu_torch.ops.render_kernel"
    monkeypatch.delitem(sys.modules, name)
    with P.profile_trace(str(tmp_path)), P.span("train.step"):
        pass
    assert name not in sys.modules
    assert P.span_summary()["counters"]["render_kernel_launches"] == 0


def test_span_summary_self_times():
    P.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with P.span("train.step"):
                time.sleep(0.002)
                with P.span("train.backward"):
                    time.sleep(0.004)
    s = P.span_summary()["spans"]
    assert s["train.step"]["count"] == s["train.backward"]["count"] == 2
    assert s["train.backward"]["host_self_ms"] == s["train.backward"]["host_ms"] >= 8.0
    assert s["train.step"]["host_self_ms"] == pytest.approx(
        s["train.step"]["host_ms"] - s["train.backward"]["host_ms"])
    assert 4.0 <= s["train.step"]["host_self_ms"] < s["train.step"]["host_ms"] - 8.0
    assert s["train.step"]["stream_ms"] is None and s["train.step"]["stream_self_ms"] is None


def test_stage_timer_opens_a_trainer_span():
    timer = P.StageTimer()
    P.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]), timer.stage("step"):
        pass
    with timer.stage("step"):
        pass
    assert [r["name"] for r in P.span_records()] == ["trainer.step"]
    assert set(timer.summary()) == {"step"} and timer.summary()["step"]["count"] == 2


@pytest.mark.parametrize("name", list(EVAL_METRICS) + list(TRAIN_METRICS))
def test_span_metric_reads(monkeypatch, tmp_path, name):
    """None on the CPU after a traced stretch with the spans; from a summary
    with stream times, its stage's stream ms over the tick or step count."""
    entry = next(m for m in bench_common.load_json(bench_common.ROOT / "BENCHMARK.json")["per_layer"]
                 if m["name"] == name)
    eval_metric = name in EVAL_METRICS
    rate = "env_steps_per_s" if eval_metric else "train_samples_per_s"
    assert (entry["source"], entry["unit"], entry["moves"]) == ("program_span", "ms", rate)
    assert entry["workloads"] == (["mask_unet.eval_w2048"] if name == "heat_stream_ms_per_tick" else
                                  ["mask_unet.eval_w2048", "reg.eval_w16384"] if eval_metric else
                                  ["reg.train_b2048", "mask_unet.gaze_train_b256"])
    read = bench_common.metric_reader(name)
    r = SimpleNamespace(rate_metric=rate)
    with P.profile_trace(str(tmp_path)):
        for top, stages in (("rollout.tick", EVAL_METRICS.values()), ("train.step", TRAIN_METRICS.values())):
            with P.span(top):
                for stage in list(stages) + ["rollout.ring", "rollout.noop"]:
                    if stage is not None:
                        with P.span(stage):
                            pass
    assert read(r) is None
    assert read(SimpleNamespace(rate_metric="other")) is None

    def stat(ms, self_ms=None):
        return {"count": 4 if ms is None else 8, "host_ms": 1.0, "host_self_ms": 1.0, "stream_ms": ms,
                "stream_self_ms": ms if self_ms is None else self_ms}

    spans = {"rollout.tick": {**stat(400.0, 12.0), "count": 4}, "train.step": {**stat(200.0, 4.0), "count": 2},
             "rollout.ring": stat(8.0), "rollout.noop": stat(4.0)}
    for i, stage in enumerate(list(EVAL_METRICS.values()) + list(TRAIN_METRICS.values())):
        if stage is not None:
            spans[stage] = stat(10.0 * (i + 1), 5.0 * (i + 1))
    monkeypatch.setattr(P, "span_summary", lambda: {"spans": spans, "counters": {}})
    stage = {**EVAL_METRICS, **TRAIN_METRICS}[name]
    if stage is None:
        want = (8.0 + 4.0 + 12.0) / 4
    else:
        key = "stream_self_ms" if stage == "train.forward" else "stream_ms"
        want = spans[stage][key] / (4 if eval_metric else 2)
    assert read(r) == pytest.approx(want)
