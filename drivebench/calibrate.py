"""Readings that the limits of a cell's output check are set from.

    python3 drivebench/calibrate.py --workload <cell> --seeds 11 12 ... [--control-seeds 3] [--calls 1]

For each seed: the port's numbers as a run of the cell reads them (a train
cell's first steps; an eval cell's ``--calls`` calls at the cell's size,
without a window or trace). For the first ``--control-seeds`` seeds also
the control's numbers: the reference put in the port's place, one
precision lower than the configuration states (reference/train.py,
reference/rollout.py), and for a train cell the faults that a step can
have, planted in the reference put in the port's place (half the batch
left out, the mean over the rest; one gradient altered where it is
produced). A step that returns its state unchanged reads 1 on
``grad_gap`` and ``change_gap`` by their definition and needs no run.

Prints one JSON line a seed and side, then the lower reading of each
number (the largest of the port's) and the upper one: the smallest of the
control's where that is three times the lower or more, and of each fault's
that reads ten times the lower or more.
The benchmark's runs do not run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    __package__ = "drivebench"

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from drivebench import common  # noqa: E402


def readings(name: str, seed: int, device, control: bool, calls: int, overrides=None) -> list[dict]:
    import torch

    files = common.cell_files(name)
    traffic = {**files["traffic"], **(overrides or {})}
    ctx = SimpleNamespace(seed=seed, device=device, config=files["config"], traffic=traffic)
    cell = importlib.import_module(f"drivebench.drivers.{traffic['driver']}").Cell(ctx)
    cell.setup()
    if traffic["driver"] == "rollout":
        for _ in range(calls):
            cell.run_unit()
    common.sync(device)
    cell.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if traffic["driver"] == "rollout":
        from drivebench.reference.rollout import NUMBERS, TickReference

        out = [{"seed": seed, "side": "port", **cell.check()}]
        if not control:
            return out
        ref = TickReference(cell.cfg, cell.gaze_cfg, traffic["routes"], cell.params, cell.ticks, device)
        worst = {}
        for cap in cell.caps:
            for k, v in ref.numbers(cap, control=True).items():
                worst[k] = min(worst.get(k, float("inf")), v)
        return out + [{"seed": seed, "side": "control", **{k: worst[k] for k in NUMBERS if k in worst}}]
    from drivebench.reference import train as T

    ref = T.follow(cell.kind, cell.cfg, cell.params0, cell.batches, cell.spe)
    sides = [("port", cell.prog)]
    if control:
        sides += [(side, T.follow(cell.kind, cell.cfg, cell.params0, cell.batches, cell.spe, **kw))
                  for side, kw in [("control", {"fmt": "fp8"})] + [(f, {"fault": f}) for f in T.FAULTS]]
    return [{"seed": seed, "side": side, **T.train_numbers(got, ref)} for side, got in sides]


def summary(rows: list[dict]) -> dict:
    """{number: {"lower", "upper", "upper_from"}}."""
    names = [k for k in rows[0] if k not in ("seed", "side")]
    out = {}
    for k in names:
        lower = max(r[k] for r in rows if r["side"] == "port")
        ctl = [r[k] for r in rows if r["side"] == "control"]
        cands = [(min(ctl), "control")] if ctl and min(ctl) >= 3 * lower else []
        for side in sorted({r["side"] for r in rows} - {"port", "control"}):
            v = min(r[k] for r in rows if r["side"] == side)
            if v >= 10 * lower:
                cands.append((v, side))
        up = min(cands) if cands else (None, None)
        out[k] = {"lower": lower, "upper": up[0], "upper_from": up[1]}
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(prog="drivebench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
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
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
