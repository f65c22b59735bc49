"""Experiment logging: hparam-encoding run dirs + JSONL metric streams (port
of gabril_carla_tpu/utils/logging.py; ExperimentLogger,
vlm_gaze/train/common/logging.py:14-87). Scalars stream to metrics.jsonl.
"""

from __future__ import annotations

import json
import time
from datetime import datetime
from pathlib import Path


def encode_run_name(cfg, tag: str = "") -> str:
    ts = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    bits = [
        ts,
        f"s{cfg.get_path('training.seed', 0)}",
        f"n{cfg.get_path('data.num_episodes', 0)}",
        f"stack{cfg.get_path('data.frame_stack', 1)}",
        f"gray{cfg.get_path('model.grayscale', True)}",
        f"bs{cfg.get_path('data.batch_size', 0)}",
        f"lr{cfg.get_path('optimizer.lr', 0)}",
    ]
    gm = cfg.get_path("gaze.method")
    if gm:
        bits.append(f"gaze{gm}")
    dm = cfg.get_path("dropout.method")
    if dm and dm != "None":
        bits.append(f"dp{dm}")
    if tag:
        bits.append(tag)
    return "_".join(str(b) for b in bits)


class ExperimentLogger:
    def __init__(self, cfg, task: str = "", tag: str = ""):
        root = Path(cfg.get_path("logging.log_dir", "runs"))
        # an explicit run_name pins the run directory; default is a fresh
        # timestamped name
        self.run_name = (cfg.get_path("logging.run_name", "")
                         or encode_run_name(cfg, tag or cfg.get_path("tag", "")))
        self.log_dir = root / (task or cfg.get_path("data.task", "task")) / self.run_name
        self.ckpt_dir = self.log_dir / "checkpoints"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self._metrics_path = self.log_dir / "metrics.jsonl"
        (self.log_dir / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2))
        self._t0 = time.monotonic()
        # optional TensorBoard event stream next to metrics.jsonl (the
        # reference logs Loss/epoch, Loss/actor, Loss/reg, LR scalars)
        self._tb = None
        if cfg.get_path("logging.tensorboard", False):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:  # the tensorboard package is optional
                print(f"tensorboard disabled: {e}")
            else:
                self._tb = SummaryWriter(log_dir=str(self.log_dir / "tb"))

    def log_scalars(self, step: int, scalars: dict):
        rec = {"step": step, "t": round(time.monotonic() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        with self._metrics_path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "t"):
                    self._tb.add_scalar(k, v, step)

    def print(self, msg: str):
        print(f"[{self.run_name}] {msg}", flush=True)
