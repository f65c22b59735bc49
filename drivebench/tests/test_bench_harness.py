"""The harness on the CPU at small sizes: its files, its result line, its
guard against JAX, and that its output check fails a broken program and
the lower-precision control.

Sound runs here use the configurations with ``compute_dtype`` float32, so
that the port agrees with the float32 reference to rounding and any check
that fails is the planted fault's. The card test at the end runs each
cell briefly on the card and skips without one.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from drivebench import common, run
from drivebench.calibrate import readings
from drivebench.reference.train import altered_leaf

CELLS = ("reg.train_b2048", "mask_unet.eval_w2048", "reg.eval_w16384", "mask_unet.gaze_train_b256")
TINY = {"reg.train_b2048": {"batch": 4, "trace_steps": 1},
        "mask_unet.gaze_train_b256": {"batch": 4, "trace_steps": 1},
        "mask_unet.eval_w2048": {"worlds": 4, "ticks_per_call": 13, "sample_worlds": 3,
                                "trace_from_tick": 11, "trace_ticks": 1},
        "reg.eval_w16384": {"worlds": 4, "ticks_per_call": 13, "sample_worlds": 3,
                            "trace_from_tick": 11, "trace_ticks": 1}}


def f32_files(monkeypatch):
    """Every configuration run in float32 (see the module docstring)."""
    real = common.cell_files

    def files(name):
        out = copy.deepcopy(real(name))
        for part in out["config"].values():
            if isinstance(part, dict) and "training" in part:
                part["training"]["compute_dtype"] = "float32"
        return out

    monkeypatch.setattr(common, "cell_files", files)


def run_tiny(cell, trace=0, seed=2**31 + 77):
    args = SimpleNamespace(workload=cell, seed=seed, seconds=0.0, trace=trace)
    return run.run(args, device="cpu", overrides=TINY[cell])


def test_benchmark_files_are_found():
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    assert bench["command"][1] == "drivebench/run.py" and (common.ROOT / bench["command"][1]).is_file()
    assert {w["name"] for w in bench["workloads"]} == set(CELLS)
    for c in bench["configs"]:
        assert (common.ROOT / c["file"]).is_file() and c["file"].startswith("drivebench/")
    for w in bench["workloads"]:
        files = common.cell_files(w["name"])
        assert files["per_layer"] and files["end_to_end"]
        assert (common.BENCH / "drivers" / f"{files['traffic']['driver']}.py").is_file()
    for m in bench["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


@pytest.mark.parametrize("trace", (0, 1))
def test_result_line_keys(monkeypatch, trace):
    f32_files(monkeypatch)
    line = run_tiny("reg.train_b2048", trace)
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    names = {m["name"] for m in common.cell_files("reg.train_b2048")["end_to_end"]}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        assert set(line["metrics"]) <= {"mfu_pct.train", "idle_pct.train"}
    else:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_no_jax_is_loaded():
    code = ("import sys, json; sys.path.insert(0, '.'); from types import SimpleNamespace\n"
            "from drivebench import run, common\n"
            "from drivebench.tests.test_bench_harness import TINY\n"
            "a = SimpleNamespace(workload='reg.eval_w16384', seed=5, seconds=0.0, trace=0)\n"
            "line = run.run(a, device='cpu', overrides=TINY['reg.eval_w16384'])\n"
            "print(json.dumps({'line': line is not None, 'found': common.forbidden_modules(),\n"
            "  'port': 'gabril_carla_tpu_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True, text=True,
                         timeout=600)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"line": True, "found": [], "port": True}


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("gabril_carla_tpu_torch_x", None)
    try:
        assert "gabril_carla_tpu" not in common.forbidden_modules()
    finally:
        sys.modules.pop("gabril_carla_tpu_torch_x", None)


def test_exits_nonzero_without_card_or_program(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    args = ["--workload", "reg.train_b2048", "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, "drivebench/run.py", *args], cwd=common.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.BENCH, tmp_path / "drivebench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "drivebench/run.py", *args], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# --- planted faults ----------------------------------------------------------


def _unchanged_state(monkeypatch):
    from gabril_carla_tpu_torch.train.optim import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self, grads: self)


def _loss_fn_module(cell):
    from gabril_carla_tpu_torch.train import bc, gaze_predictor

    return (bc, "loss_and_grads") if "gaze" not in cell else (gaze_predictor, "gaze_loss_and_grads")


def _half_batch(monkeypatch, cell):
    mod, name = _loss_fn_module(cell)
    real = getattr(mod, name)

    def half(*args):
        args = list(args)
        i = next(i for i, a in enumerate(args) if isinstance(a, dict) and "obs_seq" in a)
        args[i] = {k: v[: v.shape[0] // 2] for k, v in args[i].items()}
        return real(*args)

    monkeypatch.setattr(mod, name, half)


def _altered_grad(monkeypatch, cell):
    mod, name = _loss_fn_module(cell)
    real = getattr(mod, name)

    def altered(*args):
        loss, metrics, grads = real(*args)
        k = altered_leaf(grads)
        return loss, metrics, {**grads, k: 2.0 * grads[k]}

    monkeypatch.setattr(mod, name, altered)


def _env_unchanged(monkeypatch, cell):
    from gabril_carla_tpu_torch.env.env import DrivingEnv

    monkeypatch.setattr(DrivingEnv, "step", lambda self, spec, state, action, draws: state)


def _policy(monkeypatch, change):
    from gabril_carla_tpu_torch.train import bc

    real = bc.make_bc_policy_fn

    def make(models, cfg):
        fn = real(models, cfg)
        return lambda params, obs, heat=None: change(fn(params, obs, heat))

    monkeypatch.setattr(bc, "make_bc_policy_fn", make)


def _policy_half(monkeypatch, cell):
    def half(a):
        a = a.clone()
        a[a.shape[0] // 2:] = 0.0
        return a

    _policy(monkeypatch, half)


def _action_altered(monkeypatch, cell):
    def steer_flipped(a):
        a = a.clone()
        a[:, 1] = -a[:, 1]
        return a

    _policy(monkeypatch, steer_flipped)


FAULTS = {"reg.train_b2048": {"unchanged": lambda mp, c: _unchanged_state(mp),
                              "half_batch": _half_batch, "altered": _altered_grad},
          "mask_unet.gaze_train_b256": {"unchanged": lambda mp, c: _unchanged_state(mp),
                                        "half_batch": _half_batch, "altered": _altered_grad},
          "mask_unet.eval_w2048": {"unchanged": _env_unchanged, "half_batch": _policy_half,
                                  "altered": _action_altered},
          "reg.eval_w16384": {"unchanged": _env_unchanged, "half_batch": _policy_half,
                              "altered": _action_altered}}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in (None, "unchanged", "half_batch", "altered")])
def test_output_check_fails_a_broken_program(monkeypatch, cell, fault):
    f32_files(monkeypatch)
    if fault is not None:
        FAULTS[cell][fault](monkeypatch, cell)
    line = run_tiny(cell)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The reference one precision lower than the configuration states, in
    the port's place, fails at least one of the cell's limits."""
    rows = readings(cell, 2**31 + 5, torch.device("cpu"), True, 1, TINY[cell])
    control = next(r for r in rows if r["side"] == "control")
    limits = common.cell_files(cell)["limits"]
    assert any(control[k] > v for k, v in limits.items() if k in control), (control, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "drivebench/run.py", "--workload", cell, "--seed", "12345",
                          "--seconds", "2", "--trace", "0"], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
