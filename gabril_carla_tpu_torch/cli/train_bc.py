"""BC training CLI (port of gabril_carla_tpu/cli/train_bc.py; the
vlm_gaze/train/train_bc.py surface, Hydra -> dotted overrides).

    python -m gabril_carla_tpu_torch.cli.train_bc [--config YAML] key.sub=value ...

Waiting in ROADMAP.md, and refused with NotImplementedError: reading an
HDF5 dataset (``data.hdf5_path``, M9: the card's machine has no h5py) and
``--resume`` (full-state resume).
"""

from __future__ import annotations

import argparse

from ..data.dataset import BCDataset, synthetic_episodes
from ..train.loop import Trainer
from ..utils.config import default_bc_config, load_config


def build_dataset(cfg) -> BCDataset:
    if cfg.data.get("hdf5_path", ""):
        raise NotImplementedError("data.hdf5_path: load_hdf5 is queued in ROADMAP.md (M9; the "
                                  "card's machine has no h5py)")
    # synthetic fallback so the pipeline is runnable anywhere
    store = synthetic_episodes(n_demos=4, steps=64,
                               img_hw=(cfg.data["img_height"], cfg.data["img_width"]),
                               max_points=cfg.gaze.get("max_points", 5),
                               action_dim=cfg.data["action_dim"])
    return BCDataset(store, frame_stack=cfg.data["frame_stack"])


def parse(argv, base: dict, resume: bool = True):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="YAML config path")
    if resume:
        p.add_argument("--resume", default=None, metavar="RUN_DIR",
                       help="continue an existing run (queued in ROADMAP.md: full-state resume)")
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = p.parse_args(argv)
    if getattr(args, "resume", None):
        raise NotImplementedError("--resume: full-state resume is queued in ROADMAP.md")
    return load_config(args.config, args.overrides, base=base)


def main(argv=None, mode: str = "bc", device="cuda"):
    cfg = parse(argv, default_bc_config().to_dict())
    trainer = Trainer(cfg, build_dataset(cfg), mode=mode, device=device)
    metrics = trainer.train()
    print("Training completed!", metrics)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
