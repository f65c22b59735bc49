"""Gaze-predictor training CLI (port of
gabril_carla_tpu/cli/train_gaze_predictor.py; the
vlm_gaze/train/train_gaze_predictor.py surface).

    python -m gabril_carla_tpu_torch.cli.train_gaze_predictor [--config YAML] key=value ...
"""

from __future__ import annotations

from ..train.loop import Trainer
from ..utils.config import default_gaze_config
from .train_bc import build_dataset, parse


def main(argv=None, device="cuda"):
    cfg, _ = parse(argv, default_gaze_config().to_dict(), resume=False)
    trainer = Trainer(cfg, build_dataset(cfg), mode="gaze", device=device)
    metrics = trainer.train()
    print("Training completed!", metrics)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
