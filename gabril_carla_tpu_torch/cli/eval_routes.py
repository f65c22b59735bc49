"""Closed-loop route evaluation CLI (port of
gabril_carla_tpu/cli/eval_routes.py): one batched rollout evaluates every
(route, seed) pair and writes per-route stats.json plus aggregate.json,
instead of one CARLA server per route per seed driven by bash loops
(vlm_gaze/eval/seen_eval.sh:72-94).

    python -m gabril_carla_tpu_torch.cli.eval_routes --checkpoint RUN/checkpoints

Resume parity with RouteIndexer.validate_and_resume (route_indexer.py:
40-93): pairs whose stats.json exists are skipped unless --no-resume. Each
pair's env draws come from its own generator seeded with
seed * 100003 + route, so a resumed subset writes the same stats.json as a
full run. ``--xosc`` (ROADMAP.md M13) and ``--video`` (M14) raise
NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..data.tasks import TASK_TO_ROUTE
from ..data.vendored import routes_path
from ..env.criteria import compute_score
from ..env.env import DRAWS_PER_STEP
from ..env.world import load_benchmark_specs, to_torch
from ..eval.agent import BCAgent
from ..eval.rollout import make_rollout_fn, needs_heat
from ..eval.stats import aggregate_scores, route_record, write_stats_json


def pair_draws(pairs, steps: int, device) -> torch.Tensor:
    """[steps, len(pairs), 4] env draws, each pair's column from its own
    generator seeded with seed * 100003 + route."""
    cols = [torch.rand((steps, DRAWS_PER_STEP), device=device,
                       generator=torch.Generator(device=device).manual_seed(s * 100003 + r))
            for r, s in pairs]
    return torch.stack(cols, 1)


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True, help="checkpoint dir containing params.json")
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--routes_xml", default=str(routes_path()),
                   help="route table in the compiled routes220.json.gz format")
    p.add_argument("--task", default="Mixed_", help="task name or 'Mixed_'")
    p.add_argument("--split", default="test", choices=["train", "test", "test_unseen"])
    p.add_argument("--route_id", type=int, default=None, help="single route override")
    p.add_argument("--xosc", default=None,
                   help="OpenSCENARIO storyboard (queued in ROADMAP.md, M13)")
    p.add_argument("--junction_traffic", action=argparse.BooleanOptionalAction, default=True,
                   help="ambient junction crossing traffic in the eval worlds; match it to "
                        "the checkpoint's training distribution")
    p.add_argument("--seeds", type=int, nargs="*", default=None)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--out", default="eval_out")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--video", action="store_true",
                   help="an mp4 of each rollout (queued in ROADMAP.md, M14)")
    args = p.parse_args(argv)
    if args.xosc is not None:
        raise NotImplementedError("--xosc: env/xosc.py is queued in ROADMAP.md (M13)")
    if args.video:
        raise NotImplementedError("--video: eval/video.py is queued in ROADMAP.md (M14; the "
                                  "card's machine has no cv2 or ffmpeg)")

    if args.route_id is not None:
        pairs = [(args.route_id, s) for s in (args.seeds or [400])]
    else:
        pairs = TASK_TO_ROUTE[args.task][args.split]
        if args.seeds:
            pairs = [(r, s) for r, _ in pairs for s in args.seeds]

    out = Path(args.out)
    if not args.no_resume:
        pairs = [(r, s) for r, s in pairs
                 if not (out / f"route_{r}" / f"seed_{s}" / "stats.json").exists()]
    if not pairs:
        print("Nothing to do (all stats present; use --no-resume to rerun)")
        return 0

    agent = BCAgent(args.checkpoint, epoch=args.epoch, device=device)
    route_ids = sorted({r for r, _ in pairs})
    specs = load_benchmark_specs(route_ids, junction_traffic=args.junction_traffic,
                                 routes_file=args.routes_xml)
    idx_of = {r: i for i, r in enumerate(route_ids)}

    use_analytic = needs_heat(agent.cfg) and agent.gaze_predictor_apply is None
    if use_analytic:
        print("warning: heat-needing method without a trained gaze predictor in "
              "the manifest — falling back to analytic scene-graph gaze")
    roll = make_rollout_fn(agent.policy_fn(), agent.cfg, steps=args.steps,
                           gaze_predictor_apply=agent.gaze_predictor_apply,
                           use_analytic_gaze=use_analytic)

    spec_idx = np.asarray([idx_of[r] for r, _ in pairs])
    batch_spec = to_torch(type(specs)(**{k: v[spec_idx] for k, v in vars(specs).items()}), device)
    t0 = time.time()
    states, _ = roll(batch_spec, agent.params, draws=pair_draws(pairs, args.steps, device))
    t_done = states.t.cpu()
    wall = time.time() - t0
    score = {k: v.cpu() for k, v in compute_score(batch_spec, states).items()}

    records = []
    for i, (r, s) in enumerate(pairs):
        rec = route_record(
            r, s, {k: v[i] for k, v in score.items()},
            duration_game=float(t_done[i]) * 0.05,
            duration_system=wall / len(pairs),
            duration_system_mode="batch_amortized",
            route_length=float(specs.route_len[idx_of[r]]),
        )
        write_stats_json(out, rec)
        records.append(rec)
        print(f"route {r} seed {s}: score {rec['scores']['score_composed']:.2f} [{rec['status']}]")

    agg = aggregate_scores(records)
    (out / "aggregate.json").write_text(json.dumps(agg, indent=2))
    print(f"mean driving score: {agg['mean']:.2f} ± {agg['std']:.2f} over {agg['n']} runs "
          f"({wall:.1f}s wall for {len(pairs)} routes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
