"""Checkpointing: torch state-dict files + a params.json manifest (port of
gabril_carla_tpu/train/checkpoint.py; the JAX package writes Orbax trees).

``<ckpt_dir>/ep<N>/params.pt`` holds every module's parameters of epoch N
as one CPU state dict; the manifest carries the hyperparameters the eval
agent needs to rebuild the network (eval/my_agents/bc_agent.py:44-59).
``<ckpt_dir>/_resume_ep<N>/`` holds the full training state for resume
(save_resume_state).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch


def save_params(ckpt_dir: str | Path, epoch: int, params: dict) -> Path:
    path = Path(ckpt_dir).absolute() / f"ep{epoch}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path / "params.pt")
    return path


def restore_params(path: str | Path, device="cpu") -> dict:
    return torch.load(Path(path) / "params.pt", map_location=device, weights_only=True)


def tree_to(tree, device):
    """A nest of dicts holding tensors and numbers, every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree


def save_resume_state(ckpt_dir: str | Path, epoch_done: int, tree: dict, meta: dict) -> Path:
    """Preemption-safe full-state checkpoint after ``epoch_done`` epochs.

    ``<ckpt_dir>/_resume_ep<N>/tree.pt`` holds the tensors (params,
    optimizer state, step key, keep-best params); ``meta.json``
    beside it the host cursors (epoch, global step, numpy bit-generator
    state, keep-best trackers). meta.json is written atomically AFTER the
    tree, so a directory without it is the leftover of a killed save and is
    ignored on restore. Older ``_resume_ep*`` dirs are pruned only after the
    new one is complete: a kill at any instant leaves a valid checkpoint.
    The reference saves weights only (train/train_bc.py:301-335)."""
    root = Path(ckpt_dir).absolute()
    path = root / f"_resume_ep{epoch_done}"
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save(tree_to(tree, "cpu"), path / "tree.pt")
    tmp = path / "meta.json.tmp"
    tmp.write_text(json.dumps({"epoch_done": epoch_done, **meta}))
    tmp.rename(path / "meta.json")
    for other in root.glob("_resume_ep*"):
        if other != path:
            shutil.rmtree(other, ignore_errors=True)
    return path


def latest_resume_state(ckpt_dir: str | Path):
    """(tree.pt path, meta) of the newest COMPLETE resume checkpoint (one
    with meta.json), or None."""
    best = None
    for path in Path(ckpt_dir).glob("_resume_ep*"):
        meta_path = path / "meta.json"
        if not meta_path.exists():
            continue
        meta = json.loads(meta_path.read_text())
        if best is None or meta["epoch_done"] > best[1]["epoch_done"]:
            best = (path / "tree.pt", meta)
    return best


def load_resume_tree(path: str | Path) -> dict:
    """A resume tree as saved, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


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
