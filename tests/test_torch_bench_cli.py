"""The command lines of the measuring entry points,
``python -m gabril_carla_tpu_torch.bench`` and ``.bench_train``, against
the JAX repo's bench.py and bench_train.py: run as ``-m`` runs them, in
one subprocess where JAX cannot be imported and no card is visible, their
last lines carry the reference scripts' exact keys (bench.py:230-243,
bench_train.py:110-117) and mode tags; without ``--device cpu`` they exit
non-zero and print no JSON line. tests/test_torch_bench.py holds what the
lines measure to JAX.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "mode"}  # bench.py:230-243
TRAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "mfu_pct", "flops_per_step", "step_ms",
              "mode"}  # bench_train.py:110-117


# name -> (module, arguments): every run of the entry points' command lines
CLI_RUNS = {
    "real_routes": ("bench", "2", "3", "--device", "cpu"),
    "synthetic_skip_policy": ("bench", "2", "3", "--synthetic", "--skip_policy", "--device", "cpu"),
    "skip_render": ("bench", "2", "2", "--skip_render", "--device", "cpu"),
    "bench_train": ("bench_train", "4", "2", "--device", "cpu"),
    "bench_no_card": ("bench", "2", "3"),
    "bench_train_no_card": ("bench_train", "2", "3"),
}


@functools.lru_cache(maxsize=None)
def cli_runs() -> dict:
    """``python -m gabril_carla_tpu_torch.<module> args`` for every entry of
    CLI_RUNS, run as ``-m`` runs it (runpy, ``__main__``, ``sys.argv``,
    ``sys.exit``), all in one fresh interpreter where jax, flax, optax and
    orbax cannot be imported and no card is visible: {name: [exit code,
    stdout, stderr]}. Fails if a module of the JAX package was loaded."""
    code = textwrap.dedent(f"""
        import contextlib, io, json, runpy, sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
            sys.modules[name] = None
        runs = {{}}
        for key, (module, *args) in {CLI_RUNS!r}.items():
            out, err = io.StringIO(), io.StringIO()
            sys.argv = [module, *args]
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                try:
                    runpy.run_module("gabril_carla_tpu_torch." + module, run_name="__main__")
                    rc = 0
                except SystemExit as e:
                    rc = e.code
            runs[key] = [rc, out.getvalue(), err.getvalue()]
        bad = [m for m in sys.modules if m == "gabril_carla_tpu" or m.startswith("gabril_carla_tpu.")]
        assert not bad, bad
        print(json.dumps(runs))
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def last_json(run) -> dict:
    rc, out, err = run
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("run,mode", [("real_routes", "real_routes"),
                                      ("synthetic_skip_policy", "synthetic+skip_policy"),
                                      ("skip_render", "real_routes+skip_render")],
                         ids=["real_routes", "synthetic_skip_policy", "skip_render"])
def test_bench_cli_line(run, mode):
    line = last_json(cli_runs()[run])
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "rendered_env_steps_per_sec_per_chip" and line["unit"] == "steps/s"
    assert line["mode"] == mode and np.isfinite(line["value"]) and line["value"] > 0
    # bench.py rounds value and value / 20 from the unrounded rate, each to 0.1
    assert abs(line["vs_baseline"] - line["value"] / 20.0) <= 0.05 + 0.05 / 20.0 + 1e-9
    err = cli_runs()[run][2]
    stats = json.loads(next(ln for ln in err.splitlines() if ln.startswith('{"bench_stats"')))
    assert stats["bench_stats"]["render_launches"] == 0 and stats["bench_stats"]["device"] == "cpu"


@pytest.mark.parametrize("module", ["bench", "bench_train"])
def test_cli_without_card_fails(module):
    """No card and no --device cpu: a non-zero exit and no JSON line."""
    rc, out, err = cli_runs()[f"{module}_no_card"]
    assert rc != 0
    assert "{" not in out and "no CUDA device" in err


def test_bench_train_cli_line():
    line = last_json(cli_runs()["bench_train"])
    assert set(line) == TRAIN_KEYS
    assert line["metric"] == "train_samples_per_sec_per_chip" and line["unit"] == "samples/s"
    assert line["vs_baseline"] is None and line["mfu_pct"] is None
    assert line["mode"] == "bs4_bf16_Reg_cpu" and line["value"] > 0 and line["step_ms"] > 0
    # the encoder's convs and the pre-actor: about 1.80 GFLOP a sample forward, x3 with backward
    assert 0.8 < line["flops_per_step"] / (1.80e9 * 3 * 4) < 1.2
