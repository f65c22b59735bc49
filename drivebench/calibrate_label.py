"""Readings that the limits of the VLM labeling cell's output check are set
from (drivers/label.py ``numbers``).

    python3 drivebench/calibrate_label.py --workload kimi_vl.label_w256 --seeds 11 12 ... [--control-seeds 2] [--calls 1]

For each seed: the port's numbers as a run of the cell reads them, from
``--calls`` calls at the cell's size without a window or trace. For the
first ``--control-seeds`` seeds also the control's numbers, the reference
one precision lower than the configuration states (fp8 products for the
bf16 model, bf16 for the render and the env state) put in the port's
place, and each fault's (reference/kimi_vl.py FAULTS: top-5 routing, the
router's correction bias left out, the shared experts left out, RoPE off
on the latent's key, 2D RoPE off in the tower), the reference with the
fault in the port's place. drivebench/calibrate.py does the same for the
other cells.

Prints one JSON line a seed and side, then the lower reading of each
number (the largest of the port's) and the upper one: the smallest of the
control's and of each fault's that reads three times the lower or more.
The benchmark's runs do not run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    __package__ = "drivebench"

import argparse  # noqa: E402
import json  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from drivebench import common  # noqa: E402


def readings(name: str, seed: int, device, control: bool, calls: int, overrides=None) -> list[dict]:
    import torch

    from drivebench.drivers import label
    from drivebench.reference.kimi_vl import FAULTS

    files = common.cell_files(name)
    traffic = {**files["traffic"], **(overrides or {})}
    ctx = SimpleNamespace(seed=seed, device=device, config=files["config"], traffic=traffic)
    cell = label.Cell(ctx)
    cell.setup()
    for _ in range(calls):
        cell.run_unit()
    common.sync(device)
    cell.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rows = [{"seed": seed, "side": "port", **cell.check()}]
    if control:
        rows.append({"seed": seed, "side": "control", **label.numbers(cell, cell.caps, fmt="fp8")})
        for f in FAULTS:
            rows.append({"seed": seed, "side": f, **label.numbers(cell, cell.caps, fault=f)})
    return rows


def summary(rows: list[dict]) -> dict:
    """{number: {"lower", "upper", "upper_from"}}."""
    names = [k for k in rows[0] if k not in ("seed", "side")]
    out = {}
    for k in names:
        lower = max(r[k] for r in rows if r["side"] == "port")
        cands = []
        for side in sorted({r["side"] for r in rows} - {"port"}):
            v = min(r[k] for r in rows if r["side"] == side)
            if v >= 3 * lower and v > 0:
                cands.append((v, side))
        up = min(cands) if cands else (None, None)
        out[k] = {"lower": lower, "upper": up[0], "upper_from": up[1]}
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(prog="drivebench/calibrate_label.py")
    p.add_argument("--workload", default="kimi_vl.label_w256")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=2)
    p.add_argument("--calls", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        common.log("needs a CUDA card")
        return 1
    device = torch.device("cuda", 0)
    common.log(f"card: {common.power_limit()}")
    rows = []
    for i, seed in enumerate(args.seeds):
        for r in readings(args.workload, seed, device, i < args.control_seeds, args.calls):
            rows.append(r)
            print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
