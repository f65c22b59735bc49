"""Checkpointing: torch state-dict files + a params.json manifest (port of
gabril_carla_tpu/train/checkpoint.py; the JAX package writes Orbax trees).

``<ckpt_dir>/ep<N>/params.pt`` holds every module's parameters of epoch N
as one CPU state dict; the manifest carries the hyperparameters the eval
agent needs to rebuild the network (eval/my_agents/bc_agent.py:44-59).
Full-state resume is queued in ROADMAP.md (M9).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch


def save_params(ckpt_dir: str | Path, epoch: int, params: dict) -> Path:
    path = Path(ckpt_dir).absolute() / f"ep{epoch}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path / "params.pt")
    return path


def restore_params(path: str | Path, device="cpu") -> dict:
    return torch.load(Path(path) / "params.pt", map_location=device, weights_only=True)


def save_manifest(ckpt_dir: str | Path, cfg, epoch: int, extra: dict | None = None) -> Path:
    """params.json with the keys bc_agent expects (train_bc.py:318-334)."""
    manifest = {
        "gaze_method": cfg.get_path("gaze.method", "None"),
        "dp_method": cfg.get_path("dropout.method", "None"),
        "grayscale": cfg.model["grayscale"],
        "stack": cfg.data["frame_stack"],
        "embedding_dim": cfg.model["embedding_dim"],
        "num_embeddings": cfg.get_path("dropout.num_embeddings", 512),
        "num_hiddens": cfg.model["num_hiddens"],
        "num_residual_layers": cfg.model["num_residual_layers"],
        "num_residual_hiddens": cfg.model["num_residual_hiddens"],
        "z_dim": cfg.model["z_dim"],
        "arch": cfg.get_path("model.arch", "autoencoder"),
        "gaze_predictor_path": cfg.get_path("gaze.predictor_path", ""),
        "models_path": str(Path(ckpt_dir).absolute()),
        "epochs": epoch,
        "action_dim": cfg.data["action_dim"],
        # training-identity fields: (gaze_method, dp_method) alone is
        # ambiguous inside an ablation suite
        "gaze_lambda": cfg.get_path("gaze.lambda_weight", None),
        "gaze_ratio": cfg.get_path("gaze.ratio", None),
        "temporal_flag": cfg.get_path("gaze.temporal_flag", True),
    }
    if extra:
        manifest.update(extra)
    out = Path(ckpt_dir) / "params.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(manifest, indent=2))
    return out


def load_manifest(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())
