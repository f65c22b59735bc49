"""BC eval agent: rebuild the policy, and the frozen gaze predictor, from a
checkpoint manifest (port of gabril_carla_tpu/eval/agent.py).

Parity with BCAgent's model reconstruction (eval/my_agents/bc_agent.py:
44-144): read params.json, rebuild the networks from the recorded
hyperparameters, load ``ep<N>/params.pt``, and load the gaze predictor named
by 'gaze_predictor_path' when the method needs heat.
"""

from __future__ import annotations

from pathlib import Path

from ..train.bc import build_bc_models, make_bc_policy_fn
from ..train.checkpoint import load_manifest, restore_params
from ..train.gaze_predictor import build_gaze_models, make_gaze_predictor_apply
from ..utils.config import Config, default_bc_config


def manifest_to_config(manifest: dict) -> Config:
    """params.json -> training-equivalent Config."""
    cfg = default_bc_config()
    cfg["gaze"]["method"] = manifest.get("gaze_method", "None")
    cfg["dropout"]["method"] = manifest.get("dp_method", "None")
    cfg["dropout"]["num_embeddings"] = manifest.get("num_embeddings", 512)
    cfg["model"].update(
        grayscale=manifest.get("grayscale", True),
        embedding_dim=manifest.get("embedding_dim", 64),
        num_hiddens=manifest.get("num_hiddens", 128),
        num_residual_layers=manifest.get("num_residual_layers", 2),
        num_residual_hiddens=manifest.get("num_residual_hiddens", 32),
        z_dim=manifest.get("z_dim", 256),
        arch=manifest.get("arch", "autoencoder"),
    )
    cfg["data"].update(
        frame_stack=manifest.get("stack", 2),
        action_dim=manifest.get("action_dim", 7),
    )
    return cfg


class BCAgent:
    """A trained checkpoint on ``device``: ``params`` (the policy's state
    dict, with the frozen predictor's under "gaze_predictor" when there is
    one), ``policy_fn()`` and ``gaze_predictor_apply`` for make_rollout_fn."""

    def __init__(self, ckpt_dir: str | Path, epoch: int | None = None, device="cuda"):
        ckpt_dir = Path(ckpt_dir)
        manifest_path = ckpt_dir / "params.json" if ckpt_dir.is_dir() else ckpt_dir
        self.manifest = load_manifest(manifest_path)
        self.cfg = manifest_to_config(self.manifest)
        ckpt_root = Path(self.manifest.get("models_path", manifest_path.parent))
        epoch = epoch if epoch is not None else self.manifest.get("epochs")
        self.models = build_bc_models(self.cfg, device)
        self.params = restore_params(ckpt_root / f"ep{epoch}", device)
        self.policy = make_bc_policy_fn(self.models, self.cfg)

        # optional frozen gaze predictor (ViSaRL/Mask/AGIL/GMD/IGMD eval path)
        self.gaze_predictor_apply = None
        gp_path = self.manifest.get("gaze_predictor_path", "")
        if gp_path and Path(gp_path).exists():
            gp_manifest = load_manifest(Path(gp_path) / "params.json") if Path(gp_path).is_dir() else {}
            gp_cfg = manifest_to_config({**self.manifest, **gp_manifest})
            gp_cfg["gaze"] = {"sigma": 30.0, "coeff": 0.8, "max_points": 5}
            model, _ = build_gaze_models(gp_cfg, device)
            gp_root = Path(gp_manifest.get("models_path", gp_path))
            self.params = dict(self.params)
            self.params["gaze_predictor"] = restore_params(gp_root / f"ep{gp_manifest.get('epochs')}",
                                                           device)
            self.gaze_predictor_apply = make_gaze_predictor_apply(model)

    def policy_fn(self):
        return lambda params, obs, heat=None: self.policy(params, obs, heat)
