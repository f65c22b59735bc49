"""BC training CLI (port of gabril_carla_tpu/cli/train_bc.py; the
vlm_gaze/train/train_bc.py surface, Hydra -> dotted overrides).

    python -m gabril_carla_tpu_torch.cli.train_bc [--config YAML] [--resume RUN_DIR] key.sub=value ...

``data.hdf5_path`` reads a robomimic-schema HDF5 (data.gaze_key,
data.num_episodes; h5py is imported only then); without it the run trains
on synthetic episodes.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.dataset import BCDataset, load_hdf5, synthetic_episodes
from ..train.loop import Trainer
from ..utils.config import default_bc_config, load_config


def build_dataset(cfg) -> BCDataset:
    path = cfg.data.get("hdf5_path", "")
    if path:
        store = load_hdf5(path, gaze_key=cfg.data.get("gaze_key", "gaze_coords"),
                          demo_limit=cfg.data.get("num_episodes"))
    else:
        # synthetic fallback so the pipeline is runnable anywhere
        store = synthetic_episodes(n_demos=4, steps=64,
                                   img_hw=(cfg.data["img_height"], cfg.data["img_width"]),
                                   max_points=cfg.gaze.get("max_points", 5),
                                   action_dim=cfg.data["action_dim"])
    return BCDataset(store, frame_stack=cfg.data["frame_stack"])


def parse(argv, base: dict, resume: bool = True):
    """(config, run directory to resume or None)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="YAML config path")
    if resume:
        p.add_argument("--resume", default=None, metavar="RUN_DIR",
                       help="existing run directory (runs/<task>/<run_name>) to continue: "
                            "restores params, optimizer and epoch/RNG cursors from its newest "
                            "full-state checkpoint and appends to its metrics.jsonl; also turns "
                            "on per-epoch full-state autosave for this run")
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.overrides, base=base)
    run_dir = getattr(args, "resume", None)
    if run_dir:
        run_dir = Path(run_dir)
        if not run_dir.is_dir():
            raise SystemExit(f"--resume: no such run directory: {run_dir}")
        # pin the logger into the existing run: <log_dir>/<task>/<run_name>
        cfg["logging"]["run_name"] = run_dir.name
        cfg["data"]["task"] = run_dir.parent.name
        cfg["logging"]["log_dir"] = str(run_dir.parent.parent)
    return cfg, run_dir


def main(argv=None, mode: str = "bc", device="cuda"):
    cfg, run_dir = parse(argv, default_bc_config().to_dict())
    trainer = Trainer(cfg, build_dataset(cfg), mode=mode, device=device)
    metrics = trainer.train(resume=run_dir is not None)
    print("Training completed!", metrics)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
