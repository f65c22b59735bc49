"""Data collection CLI: scripted-expert episodes in the dataset layout (port
of gabril_carla_tpu/cli/collect.py).

    python -m gabril_carla_tpu_torch.cli.collect --route 3100 --seeds 200 201 --out DIR

Replaces the reference's HumanAgent collection (eval/my_agents/
human_agent.py: wheel/keyboard and a Gazepoint eye tracker) with expert
rollouts: rendered observations, expert actions and analytic gaze from the
scene graph. The seeds run as the worlds of one batched rollout, each tick
one render launch for all of them. Each seed's env draws come from its own
generator seeded with the seed, so a seed writes the same episode alone or
beside others. Per seed, <out>/route_<id>/seed_<seed>/ gets
observations.npz (uint8 [n, 180, 320, 3]), actions.npz, gaze.npz (n its
world's own ticks up to done) and stats.json. ``--replay`` re-executes a
recorded actions.npz (human_agent.py:146-148), ``--video`` adds
episode.gif (PIL, imported only then). ``--xosc`` waits for env/xosc.py
(ROADMAP.md item 6) and raises NotImplementedError.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.vendored import routes_path
from ..env.criteria import compute_score
from ..env.env import DRAWS_PER_STEP, DrivingEnv
from ..env.expert import expert_action
from ..env.world import load_benchmark_specs, to_torch
from ..eval.stats import route_record, write_stats_json
from ..ops.raster import analytic_gaze, render_frame

GAZE_POINTS = 5


def seed_draws(seeds, steps: int, device) -> torch.Tensor:
    """[steps, len(seeds), 4] env draws, each seed's column from its own
    generator seeded with the seed."""
    return torch.stack([torch.rand((steps, DRAWS_PER_STEP), device=device,
                                   generator=torch.Generator(device=device).manual_seed(s))
                        for s in seeds], 1)


@torch.inference_mode()
def collect(spec, steps: int, draws: torch.Tensor, replay_actions: torch.Tensor | None = None,
            curvature_gaze: bool = False):
    """Roll the worlds of ``spec`` for ``steps`` ticks: render, analytic
    gaze, the expert's action (or the replayed one, the same for every
    world), env step. Returns (final state, frames uint8 [steps, B, H, W],
    actions [steps, B, 7], gaze [steps, B, 10])."""
    env = DrivingEnv()
    state = env.reset(spec)
    b = spec.route_len.shape[0]
    frames, actions, gazes = [], [], []
    for t in range(steps):
        frames.append((render_frame(spec, state) * 255).to(torch.uint8))
        gazes.append(analytic_gaze(spec, state, GAZE_POINTS, curvature_anticipation=curvature_gaze))
        if replay_actions is not None:
            action = replay_actions[min(t, replay_actions.shape[0] - 1)].expand(b, -1)
        else:
            action = expert_action(spec, state)
        actions.append(action)
        state = env.step(spec, state, action, draws[t])
    return state, torch.stack(frames), torch.stack(actions), torch.stack(gazes)


def write_gif(path: Path, frames: np.ndarray):
    from PIL import Image  # only --video needs PIL

    pil = [Image.fromarray(f) for f in frames]
    pil[0].save(path, save_all=True, append_images=pil[1:], duration=50, loop=0)


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--route", type=int, help="bench2drive220 route id")
    src.add_argument("--xosc", help="OpenSCENARIO .xosc file (queued in ROADMAP.md, item 6)")
    p.add_argument("--seeds", type=int, nargs="+", default=[200])
    p.add_argument("--routes_xml", default=str(routes_path()),
                   help="route table in the compiled routes220.json.gz format")
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--out", default="dataset/bench2drive_tpu")
    p.add_argument("--replay", default=None, help="episode dir: re-execute its actions.npz")
    p.add_argument("--video", action="store_true",
                   help="also write episode.gif (AutonomousAgent's moviepy export parity)")
    p.add_argument("--curvature_gaze", action="store_true",
                   help="curvature-anticipating (tangent-point) road fixations "
                        "instead of the fixed 15 m preview (ops/raster.py)")
    args = p.parse_args(argv)
    if args.xosc:
        raise NotImplementedError("--xosc: env/xosc.py is queued in ROADMAP.md (item 6)")

    one = load_benchmark_specs([args.route], routes_file=args.routes_xml)
    n_worlds = len(args.seeds)
    spec = to_torch(type(one)(**{k: np.repeat(v, n_worlds, 0) for k, v in vars(one).items()}), device)
    replay = None
    if args.replay:
        replay = torch.from_numpy(np.load(Path(args.replay) / "actions.npz")["actions"]).to(device)

    state, frames, actions, gazes = collect(spec, args.steps, seed_draws(args.seeds, args.steps, device),
                                            replay, args.curvature_gaze)
    n_ticks = state.t.cpu().numpy()  # valid ticks per world (a world freezes at done)
    frames, actions, gazes = frames.cpu().numpy(), actions.cpu().numpy(), gazes.cpu().numpy()
    score = {k: v.cpu() for k, v in compute_score(spec, state).items()}
    route_len = float(one.route_len[0])
    for i, seed in enumerate(args.seeds):
        n = int(n_ticks[i])
        ep = Path(args.out) / f"route_{args.route}" / f"seed_{seed}"
        ep.mkdir(parents=True, exist_ok=True)
        obs = frames[:n, i, :, :, None].repeat(3, -1)
        np.savez_compressed(ep / "observations.npz", observations=obs)
        np.savez_compressed(ep / "actions.npz", actions=actions[:n, i])
        np.savez_compressed(ep / "gaze.npz", gaze=gazes[:n, i])
        if args.video:
            write_gif(ep / "episode.gif", obs[..., 0])
        rec = route_record(args.route, seed, {k: v[i] for k, v in score.items()},
                           duration_game=n * 0.05, route_length=route_len)
        write_stats_json(args.out, rec)
        print(f"route {args.route} seed {seed}: {n} ticks, "
              f"score {rec['scores']['score_composed']:.2f} [{rec['status']}] -> {ep}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
