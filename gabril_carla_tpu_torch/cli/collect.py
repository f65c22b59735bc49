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

``--gaze vlm --vlm_seed N`` also labels every tick with the VLM labeler
(saliency/vlm_labeler.py: Kimi-VL-A3B-Instruct at its published sizes on
the card, weights drawn from N, the routers' biases fitted on the first
frames) over the scene graph's boxes, and writes
its coordinates beside gaze.npz as gaze_pseudo.npz.
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
from ..saliency.pseudo_gaze import scene_boxes
from ..utils.prng import env_draws, prng_key
from ..utils.profiling import span

GAZE_POINTS = 5


def seed_draws(seeds, steps: int, device) -> torch.Tensor:
    """[steps, len(seeds), 4] env draws on ``device``: each seed's column is
    JAX's draws for a world reset on ``PRNGKey(seed)`` (JAX
    cli/collect.py:78), computed on the host."""
    return torch.from_numpy(env_draws(np.stack([prng_key(s) for s in seeds]), steps)).to(device)


@torch.inference_mode()
def collect(spec, steps: int, draws: torch.Tensor, replay_actions: torch.Tensor | None = None,
            curvature_gaze: bool = False, labeler=None):
    """Roll the worlds of ``spec`` for ``steps`` ticks: render, analytic
    gaze, the expert's action (or the replayed one, the same for every
    world), env step. Returns (final state, frames uint8 [steps, B, H, W],
    actions [steps, B, 7], gaze [steps, B, 10]); with a ``labeler``
    (saliency/vlm_labeler.py) also its coordinates [steps, B, 10] of each
    tick's frame and scene boxes."""
    env = DrivingEnv()
    state = env.reset(spec)
    b = spec.route_len.shape[0]
    frames, actions, gazes, pseudo = [], [], [], []
    for t in range(steps):
        with span("collect.tick"):
            with span("collect.render"):
                frame = (render_frame(spec, state) * 255).to(torch.uint8)
            frames.append(frame)
            gazes.append(analytic_gaze(spec, state, GAZE_POINTS, curvature_anticipation=curvature_gaze))
            if labeler is not None:
                pseudo.append(labeler.label(frame, scene_boxes(state)))
            with span("collect.expert"):
                if replay_actions is not None:
                    action = replay_actions[min(t, replay_actions.shape[0] - 1)].expand(b, -1)
                else:
                    action = expert_action(spec, state)
            actions.append(action)
            with span("collect.env_step"):
                state = env.step(spec, state, action, draws[t])
    out = (state, torch.stack(frames), torch.stack(actions), torch.stack(gazes))
    return out if labeler is None else (*out, torch.stack(pseudo))


def vlm_labeler(seed: int, cfg, device, model_cfg=None, dtype=torch.bfloat16):
    """The VLM labeler (saliency/vlm_labeler.py ``VLMLabeler``, its
    ``LabelerConfig`` ``cfg``) on Kimi-VL-A3B-Instruct at its published sizes
    (or ``model_cfg``), the weights drawn on ``device`` from ``seed``
    (models/kimi_vl.py ``KimiVL.random``, the router bias at
    ``cfg.router_bias_std``)."""
    from ..models.kimi_vl import KimiVL, KimiVLConfig
    from ..saliency.vlm_labeler import VLMLabeler

    model = KimiVL.random(model_cfg or KimiVLConfig(), seed, device, cfg.router_bias_std, dtype)
    return VLMLabeler(model, cfg)


def balance_labeler(labeler, spec) -> list[float]:
    """Fit the labeler's routers (``VLMLabeler.balance``) on the reset
    frames and scene boxes of ``spec``'s worlds. Returns each expert layer's
    heaviest-over-mean load after the fit."""
    state = DrivingEnv().reset(spec)
    with torch.inference_mode():
        frame = (render_frame(spec, state) * 255).to(torch.uint8)
    return labeler.balance(frame, scene_boxes(state))


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
    p.add_argument("--gaze", choices=("analytic", "vlm"), default="analytic",
                   help="vlm: also write gaze_pseudo.npz from the VLM labeler (saliency/vlm_labeler.py)")
    p.add_argument("--vlm_seed", type=int, default=0, help="seed of the VLM's random weights and prompt")
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

    labeler = None
    if args.gaze == "vlm":
        from ..saliency.vlm_labeler import LabelerConfig

        labeler = vlm_labeler(args.vlm_seed, LabelerConfig(seed=args.vlm_seed), device)
        balance_labeler(labeler, spec)
    out = collect(spec, args.steps, seed_draws(args.seeds, args.steps, device), replay, args.curvature_gaze,
                  labeler)
    state, frames, actions, gazes = out[:4]
    pseudo = out[4].cpu().numpy() if labeler is not None else None
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
        if pseudo is not None:
            np.savez_compressed(ep / "gaze_pseudo.npz", gaze=pseudo[:n, i])
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
