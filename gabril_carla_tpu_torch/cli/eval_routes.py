"""Closed-loop route evaluation CLI (port of
gabril_carla_tpu/cli/eval_routes.py): one batched rollout evaluates every
(route, seed) pair and writes per-route stats.json plus aggregate.json,
instead of one CARLA server per route per seed driven by bash loops
(vlm_gaze/eval/seen_eval.sh:72-94).

    python -m gabril_carla_tpu_torch.cli.eval_routes --checkpoint RUN/checkpoints

Resume parity with RouteIndexer.validate_and_resume (route_indexer.py:
40-93): pairs whose stats.json exists are skipped unless --no-resume. Each
pair's env draws are JAX's for the key ``PRNGKey(seed * 100003 + route)``
(utils/prng.py), so a pair's stats.json is the JAX package's, and a
resumed subset writes the same stats.json as a full run. ``--xosc``
evaluates one OpenSCENARIO storyboard (env/xosc.py) as a world of its own;
``--video`` writes each pair's rendered frames as rollout.mp4 beside its
stats.json (cv2, imported only then).
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..data.tasks import TASK_TO_ROUTE
from ..data.vendored import routes_path
from ..env.criteria import compute_score
from ..env.world import build_world_spec, load_benchmark_specs, spec_rows, stack_specs, to_torch
from ..env.xosc import load_xosc
from ..eval.agent import BCAgent
from ..eval.rollout import make_rollout_fn, needs_heat
from ..eval.stats import aggregate_scores, route_record, write_stats_json
from ..utils.prng import env_draws, prng_key


def pair_draws(pairs, steps: int, device) -> torch.Tensor:
    """[steps, len(pairs), 4] env draws on ``device``: each pair's column is
    JAX's draws for a world reset on ``PRNGKey(seed * 100003 + route)``
    (JAX cli/eval_routes.py:111), computed on the host."""
    keys = np.stack([prng_key(s * 100003 + r) for r, s in pairs])
    return torch.from_numpy(env_draws(keys, steps)).to(device)


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
                   help="evaluate on an OpenSCENARIO .xosc storyboard (env/xosc.py "
                        "subset) instead of benchmark routes")
    p.add_argument("--junction_traffic", action=argparse.BooleanOptionalAction, default=True,
                   help="ambient junction crossing traffic in the eval worlds; match it to "
                        "the checkpoint's training distribution")
    p.add_argument("--seeds", type=int, nargs="*", default=None)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--out", default="eval_out")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--video", action="store_true",
                   help="write an mp4 of each rollout next to its stats.json "
                        "(autonomous_agent.py:118-132 parity; needs cv2)")
    args = p.parse_args(argv)
    if args.video:
        importlib.import_module("cv2")  # fail before the rollout, naming cv2

    xosc_route = None
    if args.xosc is not None:
        xosc_route = load_xosc(args.xosc)
        pairs = [(xosc_route["id"], s) for s in (args.seeds or [400])]
    elif args.route_id is not None:
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
    if xosc_route is not None:
        route_ids = [xosc_route["id"]]
        specs = stack_specs([build_world_spec(xosc_route)])
    else:
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
                           use_analytic_gaze=use_analytic, return_frames=args.video)

    spec_idx = np.asarray([idx_of[r] for r, _ in pairs])
    batch_spec = to_torch(spec_rows(specs, spec_idx), device)
    t0 = time.time()
    states, trace = roll(batch_spec, agent.params, draws=pair_draws(pairs, args.steps, device))
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
        if args.video:
            from ..eval.video import write_mp4

            frames = trace[: max(int(t_done[i]), 1), i].cpu().numpy()
            write_mp4(frames, out / f"route_{r}" / f"seed_{s}" / "rollout.mp4")
        print(f"route {r} seed {s}: score {rec['scores']['score_composed']:.2f} [{rec['status']}]")

    agg = aggregate_scores(records)
    (out / "aggregate.json").write_text(json.dumps(agg, indent=2))
    print(f"mean driving score: {agg['mean']:.2f} ± {agg['std']:.2f} over {agg['n']} runs "
          f"({wall:.1f}s wall for {len(pairs)} routes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
