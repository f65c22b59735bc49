"""Run one cell of the benchmark once, on one card.

    python3 drivebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m drivebench.run ...``) from the root of a checkout. The cell
is an entry of BENCHMARK.json's ``workloads``; its configuration, traffic
mix, limits and per-layer metrics are files of their own names under
drivebench/ (common.py ``cell_files``), and the traffic names the driver
(drivers/<driver>.py) that builds and runs the port's entry for it.

A run: set-up (the driver builds the port's objects, makes weights and
inputs on the card from the seed and warms every shape the cell uses;
``setup_s`` counts from the process's start to its end), then the measured
window of ``--seconds`` seconds of whole steps or calls on the host clock
ending in a synchronize. With ``--trace 1`` a short steady stretch is then
traced (trace.py) and the per-layer metrics (metrics/<name>.py) are read
from it. Then the port's objects are freed and the plain reference
(reference/) judges what the window produced. The last line of stdout is
the result's JSON; the numbers compared, each beside its limit, are the last
lines of stderr and the result's last key.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the checkout importable
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    __package__ = "drivebench"

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from drivebench import common  # noqa: E402  (records the process's start)
from drivebench.counts.peaks import product_peaks  # noqa: E402

CACHE = common.ROOT / ".drivebench_cache"


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="drivebench/run.py", description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fixed_caches():
    """Kernel build caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def run(args, device=None, overrides=None) -> dict | None:
    """One run; returns the result's dict, or None where no result may be
    printed. ``device`` and ``overrides`` (of the traffic's values) are for
    the harness's own tests on the CPU; a run from the command line takes
    the card."""
    import torch

    try:
        files = common.cell_files(args.workload)
    except (FileNotFoundError, KeyError, StopIteration) as e:
        common.log(f"cell {args.workload!r} or one of its files is missing: {e!r}")
        return None
    if device is None:
        need = files["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            common.log(f"needs {need} CUDA card(s); torch sees "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return None
        device = torch.device("cuda", 0)
        common.log(f"card: {common.power_limit()}")
    device = torch.device(device)
    fixed_caches()
    torch.set_num_threads(4)
    traffic = {**files["traffic"], **(overrides or {})}
    ctx = SimpleNamespace(seed=args.seed, device=device, config=files["config"], traffic=traffic)
    cell = importlib.import_module(f"drivebench.drivers.{traffic['driver']}").Cell(ctx)

    cell.setup()
    common.sync(device)
    setup_s = time.perf_counter() - common.START
    common.log(f"set-up {setup_s:.3f} s")
    units = 0
    t0 = time.perf_counter()
    while True:
        cell.run_unit()
        units += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    common.sync(device)
    window_s = time.perf_counter() - t0
    rate = cell.units_done / window_s
    common.log(f"window {window_s:.3f} s, {units} steps or calls, {cell.rate_metric} {rate:.4f}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # a float32 product runs in TF32 where the program's settings allow it
    peaks = product_peaks(torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32)
    reading = cell.trace() if args.trace else None

    found = common.forbidden_modules()
    if found:
        common.log(f"JAX or the JAX package is loaded: {', '.join(found)}")
        return None
    cell.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.check()
    correct, checks, failed = common.judge(numbers, files["limits"])

    dev_info = {**common.card_info(device), "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": units, "failed": failed}
    if args.trace:
        r = SimpleNamespace(rate_metric=cell.rate_metric, trace=reading,
                            unit_s=window_s * cell.per_unit / cell.units_done,
                            flops=cell.flops_per_unit(), peaks=peaks,
                            k1=cell.k1_bound() if hasattr(cell, "k1_bound") else None)
        metrics = {}
        for m in files["per_layer"]:
            v = common.metric_reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        line["metrics"] = metrics
        line["device"] = {**dev_info, "busy_s": reading.busy_s, "window_s": reading.window_s}
        line["breakdown"] = reading.breakdown()
    else:
        values = {cell.rate_metric: rate, "setup_s": setup_s}
        line["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                           for m in files["end_to_end"] if m["name"] in values}
        line["device"] = dev_info
    if common.forbidden_modules():
        common.log(f"JAX or the JAX package is loaded: {', '.join(common.forbidden_modules())}")
        return None
    for name, c in checks.items():
        common.log(f"check {name} {c['value']} limit {c['limit']}")
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    line = run(parse_args(argv))
    if line is None:
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
