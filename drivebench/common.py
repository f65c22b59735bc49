"""What every cell of the benchmark shares: finding a cell's files, seeded
inputs made on the device, the traced stretch and its reading, the guard
against JAX, and the result line.

Import this before torch is used: it records the process's start, from
which ``setup_s`` counts.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

START = time.perf_counter()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# JAX, its libraries and the JAX package: none may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "gabril_carla_tpu")
SPAN = "drivebench."  # prefix of the harness's record_function spans


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration, traffic
    mix, limits and the per-layer metrics it reports, each read from the
    file of its own name. Raises FileNotFoundError or KeyError when one is
    missing."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return {"cell": cell, "bench": bench,
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json"),
            "per_layer": per_layer, "end_to_end": end_to_end}


def metric_reader(name: str):
    """``read`` of drivebench/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"drivebench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def stream_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one stream of draws of a run's ``seed``."""
    h = hashlib.sha256(":".join(str(x) for x in (seed, *stream)).encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1


def host_rng(seed: int, *stream):
    import numpy as np

    return np.random.default_rng(stream_seed(seed, *stream))


def device_gen(seed: int, stream: str, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def make_params(shapes: dict, seed: int, stream: str, device, scale: dict | None = None) -> dict:
    """Float32 weights for parameters of the given shapes, drawn on
    ``device`` from the seed in one call: a weight of fan-in n (its size
    over its first axis) N(0, 2/n), a one-axis weight (a norm's scale)
    1 + N(0, 0.01), a bias N(0, 1e-4); ``scale`` multiplies the named
    ones."""
    import torch

    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=device_gen(seed, stream, device), device=device)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        x = flat[off:off + n].view(shape)
        off += n
        if name.endswith("weight") and len(shape) >= 2:
            x = x * math.sqrt(2.0 / math.prod(shape[1:]))
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.01 * x
        out[name] = (x * (scale or {}).get(name, 1.0)).contiguous()
    return out


def sync(device):
    import torch

    if getattr(device, "type", device) == "cuda":
        torch.cuda.synchronize()


def card_info(device) -> dict:
    """``device`` of the result line, without ``memory_peak_bytes``."""
    import torch

    if getattr(device, "type", device) != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi not available"


def log(msg: str):
    print(f"drivebench: {msg}", file=sys.stderr, flush=True)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict, int]:
    """(correct, {name: {"value", "limit"}}, how many failed): every number
    the cell's limits name is present, finite and at most its limit."""
    checks, failed = {}, 0
    for name, limit in limits.items():
        v = numbers.get(name)
        failed += not (v is not None and math.isfinite(v) and v <= limit)
        checks[name] = {"value": v, "limit": limit}
    return failed == 0, checks, failed


def tmp_dir() -> Path:
    """A directory for the trace: under TMPDIR, else inside the checkout."""
    base = os.environ.get("TMPDIR")
    return Path(base) if base else ROOT / ".drivebench_tmp"
