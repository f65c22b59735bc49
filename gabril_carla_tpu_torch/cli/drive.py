"""Interactive human driving + data collection (HumanAgent surface; port of
gabril_carla_tpu/cli/drive.py).

    python -m gabril_carla_tpu_torch.cli.drive --route 3100 --seed 200 --gaze mouse

A pygame window shows the rendered camera; arrows drive, q quits and saves
the episode under --out (observations, actions, gaze, stats.json). With
SDL_VIDEODRIVER=dummy it runs headless.
"""

from __future__ import annotations

import argparse


def main(argv=None, device="cuda"):
    from ..data.vendored import routes_path
    from ..env.world import load_benchmark_specs
    from ..eval.human import HumanLoop

    p = argparse.ArgumentParser()
    p.add_argument("--route", type=int, required=True)
    p.add_argument("--seed", type=int, default=200)
    p.add_argument("--routes_xml", default=str(routes_path()),
                   help="route table: the compiled routes220.json.gz or the reference's bench2drive220.xml")
    p.add_argument("--gaze", default="mouse", choices=["mouse", "center", "dummy", "gazepoint"])
    p.add_argument("--out", default="dataset/bench2drive_tpu_human")
    p.add_argument("--display_scale", type=int, default=3)
    p.add_argument("--controller", default="keyboard", choices=["keyboard", "joystick"],
                   help="driving input device (human_agent.py:120 parity)")
    args = p.parse_args(argv)

    spec = load_benchmark_specs([args.route], routes_file=args.routes_xml)
    HumanLoop(spec, args.out, gaze=args.gaze, display_scale=args.display_scale,
              controller=args.controller, device=device).run(args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
