"""Behavior-cloning policy (port of gabril_carla_tpu/train/bc.py, policy part).

The slice covers the configuration the closed-loop benchmark runs: gaze
method "None" and dropout "None", whose policy is encoder -> pre-actor ->
actor on the stacked frames. Every other gaze or dropout method is queued in
ROADMAP.md (port queue) and raises NotImplementedError here.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.func import functional_call

from ..models.encoder import Encoder
from ..models.heads import Actor, PreActor

PORTED_GAZE = ("None",)
PORTED_DROPOUT = ("None",)
LATENT_HW = (20, 38)  # encoder output for 180x320 frames


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.get_path("training.compute_dtype", "float32") == "bfloat16" else torch.float32


def _check_ported(cfg):
    g, d = cfg.gaze["method"], cfg.dropout["method"]
    if g not in PORTED_GAZE or d not in PORTED_DROPOUT:
        raise NotImplementedError(
            f"gaze method {g!r} / dropout {d!r}: the port covers gaze 'None' with dropout "
            "'None'; the other input branches are queued in ROADMAP.md (port queue)")


def encoder_input_channels(cfg) -> int:
    """coeff * S * (1|3), coeff=2 for ViSaRL (train_bc.py:60-61)."""
    coeff = 2 if cfg.gaze["method"] == "ViSaRL" else 1
    per = 1 if cfg.model["grayscale"] else 3
    return coeff * cfg.data["frame_stack"] * per


class BCPolicy(nn.Module):
    """encoder -> pre_actor -> actor; obs [B, C, H, W] -> float32 logits [B, A]."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg.model
        dt = _dtype(cfg)
        self.encoder = Encoder(encoder_input_channels(cfg), m["embedding_dim"], m["num_hiddens"],
                               m["num_residual_layers"], m["num_residual_hiddens"], dt)
        self.pre_actor = PreActor(m["embedding_dim"] * LATENT_HW[0] * LATENT_HW[1], m["z_dim"], dt)
        self.actor = Actor(cfg.data["action_dim"], m["z_dim"], dt)

    def forward(self, obs):
        return self.actor(self.pre_actor(self.encoder(obs))).float()


def build_bc_models(cfg, device="cuda") -> BCPolicy:
    """The policy module for ``cfg``, its (float32) parameters on ``device``."""
    _check_ported(cfg)
    if (cfg.data["img_height"], cfg.data["img_width"]) != (180, 320):
        raise ValueError("the policy's pre-actor is sized for 180x320 frames")
    return BCPolicy(cfg).to(device)


def init_bc_params(models: BCPolicy, cfg, generator: torch.Generator) -> dict:
    """Orthogonal init from ``generator`` (relu gain for convs, gain 1 for
    dense, zero biases, as flax's initializers in models/encoder.py), in
    place; returns the state dict."""
    with torch.no_grad():
        for mod in models.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                gain = math.sqrt(2.0) if isinstance(mod, nn.Conv2d) else 1.0
                w = torch.empty(mod.weight.shape, dtype=torch.float32, device=generator.device)
                nn.init.orthogonal_(w, gain=gain, generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
    return models.state_dict()


def make_bc_policy_fn(models: BCPolicy, cfg):
    """Eval-time policy: (params, obs [B, H, W, S], heat=None) -> float32 [B, A].

    ``params`` is a state dict of ``models``; ``obs`` keeps the JAX package's
    NHWC layout (a channels-last view feeds the convs without a copy).
    """
    _check_ported(cfg)
    if _dtype(cfg) == torch.float32:
        # a float32 policy computes in full float32 on the card, as the JAX
        # reference does (cuDNN would take TF32 convolutions by default)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def policy(params, obs, heat=None):
        if heat is not None:
            raise NotImplementedError("gaze heat inputs are queued in ROADMAP.md (port queue)")
        return functional_call(models, params, (obs.permute(0, 3, 1, 2),))

    return policy
