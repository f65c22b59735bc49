"""Config surface: nested dicts with attribute access, YAML files with
``_base_`` inheritance, dotted CLI overrides, and the BC and gaze-predictor
defaults (a copy of gabril_carla_tpu/utils/config.py).

``load_config`` imports ``yaml`` only when it is given a path, so dotted
overrides work where PyYAML is not installed.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any


class Config(dict):
    """Dict with attribute access, recursively."""

    def __getattr__(self, k: str) -> Any:
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: dict = self
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        return json.loads(json.dumps(self))


def _deep_update(base: dict, upd: dict) -> dict:
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except (json.JSONDecodeError, ValueError):
        low = s.lower()
        if low in ("true", "false"):
            return low == "true"
        if low == "null":  # note: "none" stays a string (scheduler.type=none)
            return None
        return s


def load_config(path: str | Path | None = None, overrides: list[str] | None = None,
                base: dict | None = None) -> Config:
    """Load YAML config with `_base_` inheritance and dotted overrides."""
    cfg: dict = copy.deepcopy(base) if base else {}
    if path is not None:
        import yaml

        path = Path(path)
        raw = yaml.safe_load(path.read_text()) or {}
        if "_base_" in raw:
            parent = load_config(path.parent / raw.pop("_base_"))
            cfg = _deep_update(dict(parent), cfg)
            raw = dict(raw)
        cfg = _deep_update(cfg, raw)
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        c = Config(cfg)
        c.set_path(key.strip(), _parse_value(val.strip()))
        cfg = dict(c)
    return Config(cfg)


def default_bc_config() -> Config:
    """Defaults matching vlm_gaze/configs/train_bc_base.yaml."""
    return Config(
        {
            "data": {
                "task": "Mixed_",
                "hdf5_path": "",
                "num_episodes": 200,
                "batch_size": 256,
                "frame_stack": 2,
                "img_height": 180,
                "img_width": 320,
                "action_dim": 7,
                "gaze_key": "gaze_coords",
            },
            "model": {
                "grayscale": True,
                "embedding_dim": 64,
                "num_hiddens": 128,
                "num_residual_layers": 2,
                "num_residual_hiddens": 32,
                "z_dim": 256,
            },
            "gaze": {
                "method": "Reg",  # None, Teacher, Reg, Mask, Contrastive, ViSaRL, AGIL, GRIL
                "mask_sigma": 30.0,
                "mask_coeff": 0.8,
                "max_points": 5,
                "beta": 50.0,
                "lambda_weight": 10.0,
                "contrastive_threshold": 10.0,
                "prob_dist_type": "MSE",  # MSE, TV, KL, JS
                "ratio": 1.0,
                "temporal_flag": True,
                "temporal_alpha": 0.7,
                "temporal_mode": "alpha_decay",
                "temporal_sigmas": None,
                "temporal_coeffs": None,
                "temporal_offset_start": 0,
            },
            "dropout": {
                "method": "None",  # None, Oreo, IGMD, GMD
                "num_embeddings": 512,
                "oreo_num_mask": 4,
                "oreo_prob": 0.5,
                "vqvae_path": "",
            },
            "optimizer": {"type": "adam", "lr": 5e-4, "weight_decay": 0.0},
            "scheduler": {
                "type": "cosine_warmup",
                "step_size": 50,
                "gamma": 0.5,
                "eta_min": 1e-6,
                "warmup_steps": 500,
                "T_0": 10,
                "T_mult": 1,
                "pct_start": 0.3,
                "div_factor": 25.0,
                "final_div_factor": 10000.0,
            },
            "training": {
                "seed": 42,
                "epochs": 10,
                "save_interval": 50,
                "gradient_accumulation_steps": 1,
                "compute_dtype": "bfloat16",
                "donate": True,
            },
            "logging": {"log_dir": "runs", "checkpoint_dir": "runs", "save_params": True,
                        "tensorboard": False},
            "tag": "",
        }
    )


def default_gaze_config() -> Config:
    """Defaults for the gaze-predictor trainer (train_gaze.yaml surface)."""
    cfg = default_bc_config()
    cfg["gaze"] = {
        "sigma": 30.0,
        "coeff": 0.8,
        "max_points": 5,
        "temporal_mode": "alpha_decay",
        "temporal_alpha": 0.7,
        "temporal_sigmas": None,
        "temporal_coeffs": None,
        "temporal_offset_start": 0,
    }
    cfg["optimizer"]["lr"] = 1e-3
    return cfg
