"""The VLM labeling cell's driver (drivers/label.py) on the CPU at a tiny
size, through ``run`` with the traffic's values overridden: a tiny Kimi-VL
in float32, so that the port agrees with the float32 reference to rounding
and a failed check is the planted fault's. The card test at the end runs
the cell briefly on the card and skips without one."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from drivebench import common, run

TINY_MODEL = {"vocab_size": 1280, "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
              "num_hidden_layers": 4, "num_attention_heads": 4, "n_shared_experts": 1, "n_routed_experts": 8,
              "num_experts_per_tok": 2, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
              "v_head_dim": 16,
              "assumed": {"vision": {"vit_hidden_size": 32, "vit_layers": 2, "vit_heads": 2,
                                     "vit_intermediate_size": 64},
                          "weights": {"dtype": "float32"}}}
TINY = {"kimi_vl.label_w256": {"worlds": 3, "ticks_per_call": 3, "sample_worlds": 2, "trace_from_tick": 1,
                               "trace_ticks": 1, "model": TINY_MODEL}}
CELLS = tuple(TINY)


def run_tiny(cell, trace=0, seed=2**31 + 91):
    args = SimpleNamespace(workload=cell, seed=seed, seconds=0.0, trace=trace)
    return run.run(args, device="cpu", overrides=TINY[cell])


def test_cells_and_their_files():
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    names = {w["name"]: w for w in bench["workloads"]}
    assert names["kimi_vl.label_w256"]["chips"] == 1
    for cell in CELLS:
        files = common.cell_files(cell)
        assert files["per_layer"] and {m["name"] for m in files["end_to_end"]} >= {"setup_s"}
        assert (common.BENCH / "drivers" / f"{files['traffic']['driver']}.py").is_file()
    conf = common.cell_files("kimi_vl.label_w256")["config"]
    assert conf["n_routed_experts"] == 64 and conf["num_hidden_layers"] == 27 and conf["vocab_size"] == 163840


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = run_tiny(cell)
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks" and set(line["metrics"]) >= {"setup_s"}
    for m in line["metrics"].values():
        assert math.isfinite(m["value"])


def test_traced_label_run_reads_its_metrics():
    line = run_tiny("kimi_vl.label_w256", trace=1)
    assert line["correct"] is True
    # on the CPU the stream metrics and the roofline read nothing: no CUDA events, no device time
    assert set(line["metrics"]) == {"mfu_pct.label", "idle_pct.label"}
    json.dumps(line)


def _zero_coords(monkeypatch):
    from gabril_carla_tpu_torch.saliency import vlm_labeler

    real = vlm_labeler.VLMLabeler.parse
    monkeypatch.setattr(vlm_labeler.VLMLabeler, "parse", lambda self, g, p: real(self, g, p) * 0.0)


def _wrong_last_position(monkeypatch):
    """A ragged-batch indexing fault: each prompt's logits taken at its
    first token in place of its last."""
    from gabril_carla_tpu_torch.models import kimi_vl

    monkeypatch.setattr(kimi_vl.Packed, "last", property(lambda self: self.starts))


def _env_unchanged(monkeypatch):
    from gabril_carla_tpu_torch.env.env import DrivingEnv

    monkeypatch.setattr(DrivingEnv, "step", lambda self, spec, state, action, draws: state)


@pytest.mark.parametrize("fault", [_zero_coords, _wrong_last_position, _env_unchanged])
def test_label_check_fails_a_broken_program(monkeypatch, fault):
    fault(monkeypatch)
    assert run_tiny("kimi_vl.label_w256")["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell):
    need = common.cell_files(cell)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        pytest.skip(f"needs {need} CUDA card(s)")
    out = subprocess.run([sys.executable, "drivebench/run.py", "--workload", cell, "--seed", "12345",
                          "--seconds", "2", "--trace", "0"], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
