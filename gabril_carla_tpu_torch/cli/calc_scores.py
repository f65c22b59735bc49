"""Score aggregation over a stats.json tree (port of
gabril_carla_tpu/cli/calc_scores.py; eval/calc_scores.py:8-60 parity).

    python -m gabril_carla_tpu_torch.cli.calc_scores --stats_dir eval_out
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..eval.stats import aggregate_scores


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--stats_dir", required=True)
    args = p.parse_args(argv)
    records = [json.loads(f.read_text())
               for f in sorted(Path(args.stats_dir).glob("route_*/seed_*/stats.json"))]
    if not records:
        print("no stats.json found under", args.stats_dir)
        return 1
    print(json.dumps(aggregate_scores(records), indent=2))
    # the batched evaluator spreads one wall clock over its rollouts, so a
    # record's duration_system is not a per-route wall time like the
    # reference's single-server runs (statistics_manager.py meta durations)
    n_amort = sum(1 for r in records
                  if r.get("meta", {}).get("duration_system_mode") == "batch_amortized")
    if n_amort:
        print(f"note: duration_system is batch-amortized (one vmapped wall "
              f"clock / n rollouts) on {n_amort}/{len(records)} records — "
              f"not comparable to the reference's per-route wall times",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
