"""Data collection CLI: scripted-expert episodes in the dataset layout (port
of gabril_carla_tpu/cli/collect.py).

    python -m gabril_carla_tpu_torch.cli.collect --route 3100 --seeds 200 201 --out DIR
    python -m gabril_carla_tpu_torch.cli.collect --xosc STORYBOARD.xosc --out DIR

Replaces the reference's HumanAgent collection (eval/my_agents/
human_agent.py: wheel/keyboard and a Gazepoint eye tracker) with expert
rollouts: rendered observations, expert actions and analytic gaze from the
scene graph. The seeds run as the worlds of one batched rollout, each tick
one render launch for all of them. Each seed's env draws are JAX's for the key
``PRNGKey(seed)`` (utils/prng.py), so a seed writes the same episode alone
or beside others, and the JAX package's episode. Per seed, <out>/route_<id>/seed_<seed>/ gets
observations.npz (uint8 [n, 180, 320, 3]), actions.npz, gaze.npz (n its
world's own ticks up to done) and stats.json. ``--replay`` re-executes a
recorded actions.npz (human_agent.py:146-148), ``--video`` adds
episode.gif (PIL, imported only then). ``--xosc`` collects on an
OpenSCENARIO storyboard (env/xosc.py) in place of a benchmark route; its
episodes go under route_<storyboard name>.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.vendored import routes_path
from ..env.criteria import compute_score
from ..env.env import DrivingEnv
from ..env.expert import expert_action
from ..env.world import build_world_spec, load_benchmark_specs, spec_rows, stack_specs, to_torch
from ..env.xosc import load_xosc
from ..eval.stats import route_record, write_stats_json
from ..ops.raster import analytic_gaze, render_frame
from ..utils.prng import env_draws, prng_key

GAZE_POINTS = 5


def seed_draws(seeds, steps: int, device) -> torch.Tensor:
    """[steps, len(seeds), 4] env draws on ``device``: each seed's column is
    JAX's draws for a world reset on ``PRNGKey(seed)`` (JAX
    cli/collect.py:78), computed on the host."""
    return torch.from_numpy(env_draws(np.stack([prng_key(s) for s in seeds]), steps)).to(device)


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
    src.add_argument("--xosc", help="OpenSCENARIO .xosc file (env/xosc.py subset)")
    p.add_argument("--seeds", type=int, nargs="+", default=[200])
    p.add_argument("--routes_xml", default=str(routes_path()),
                   help="route table: the compiled routes220.json.gz or the reference's bench2drive220.xml")
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
        route = load_xosc(args.xosc)
        one = stack_specs([build_world_spec(route)])
        route_label = route["name"]
    else:
        one = load_benchmark_specs([args.route], routes_file=args.routes_xml)
        route_label = args.route
    n_worlds = len(args.seeds)
    spec = to_torch(spec_rows(one, np.zeros(n_worlds, np.int64)), device)
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
        ep = Path(args.out) / f"route_{route_label}" / f"seed_{seed}"
        ep.mkdir(parents=True, exist_ok=True)
        obs = frames[:n, i, :, :, None].repeat(3, -1)
        np.savez_compressed(ep / "observations.npz", observations=obs)
        np.savez_compressed(ep / "actions.npz", actions=actions[:n, i])
        np.savez_compressed(ep / "gaze.npz", gaze=gazes[:n, i])
        if args.video:
            write_gif(ep / "episode.gif", obs[..., 0])
        rec = route_record(route_label, seed, {k: v[i] for k, v in score.items()},
                           duration_game=n * 0.05, route_length=route_len)
        write_stats_json(args.out, rec)
        print(f"route {route_label} seed {seed}: {n} ticks, "
              f"score {rec['scores']['score_composed']:.2f} [{rec['status']}] -> {ep}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
