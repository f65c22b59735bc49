"""The reference's models, losses and train steps, in float32.

The BC policy (encoder, pre-actor, actor; gaze methods None, Reg and Mask,
dropout None) and the UNet gaze predictor, built from the frozen modules
with the port's parameter names, so that the benchmark's weights load into
both sides. The losses are written out here from the published recipe
(vlm_gaze train_bc.py:133-194 and :203-299 for the methods above;
train_gaze_predictor.py:83-101), not copied from the port's train step.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from .frozen.models.encoder import Encoder, latent_hw
from .frozen.models.heads import Actor, PreActor
from .frozen.models.unet import UNet
from .frozen.ops.gaze import gaze_mask_from_latent
from .frozen.ops.heatmap import GazeHeatmapper
from .frozen.train.optim import build_optimizer

BC_METHODS = ("None", "Reg", "Mask")


def f32_only():
    """Full float32 products on the card: TF32 off for cuDNN and cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _check_bc(cfg):
    g, d = cfg["gaze"], cfg["dropout"]
    if g["method"] not in BC_METHODS or d["method"] != "None":
        raise NotImplementedError(f"reference: gaze {g['method']!r} / dropout {d['method']!r}")
    if g["method"] == "Reg" and (g["prob_dist_type"] != "MSE" or float(g.get("ratio", 1.0)) < 1.0):
        raise NotImplementedError("reference: Reg with MSE and ratio 1 only")


class Policy(nn.Module):
    """encoder -> pre_actor -> actor, float32; Mask multiplies the frames by
    the heat first."""

    def __init__(self, cfg):
        super().__init__()
        _check_bc(cfg)
        m, d = cfg["model"], cfg["data"]
        per = 1 if m["grayscale"] else 3
        lh, lw = latent_hw(d["img_height"], d["img_width"])
        self.encoder = Encoder(d["frame_stack"] * per, m["embedding_dim"], m["num_hiddens"],
                               m["num_residual_layers"], m["num_residual_hiddens"])
        self.pre_actor = PreActor(m["embedding_dim"] * lh * lw, m["z_dim"])
        self.actor = Actor(d["action_dim"], m["z_dim"])
        self.method = cfg["gaze"]["method"]

    def forward(self, obs, heat=None, parts: bool = False):
        """obs [B, S, H, W], heat [B, S, H, W] -> actions [B, A], or (latent,
        actions) with ``parts``."""
        z = self.encoder(obs * heat if self.method == "Mask" else obs)
        out = self.actor(self.pre_actor(z))
        return (z, out) if parts else out


def heatmapper(cfg, gaze_cfg: bool = False) -> GazeHeatmapper:
    g, d = cfg["gaze"], cfg["data"]
    return GazeHeatmapper(img_height=d["img_height"], img_width=d["img_width"],
                          gaze_sigma=g["sigma"] if gaze_cfg else g["mask_sigma"],
                          gaze_coeff=g["coeff"] if gaze_cfg else g["mask_coeff"],
                          maxpoints=g["max_points"], temporal_alpha=g["temporal_alpha"],
                          temporal_mode=g["temporal_mode"])


def bc_loss(policy: Policy, cfg, params, batch):
    """Total BC loss: actions' MSE plus lambda times Reg's MSE between the
    aggregated gaze heat of the last frame and the latent's saliency mask
    (Mask and None: actions only)."""
    g, d = cfg["gaze"], cfg["data"]
    hm = heatmapper(cfg)
    obs, heat, _ = hm.prepare_for_bc(batch["obs_seq"], batch["gaze_seq"], d["frame_stack"],
                                     grayscale=cfg["model"]["grayscale"],
                                     aggregate_stack=bool(g["temporal_flag"]))
    z, out = functional_call(policy, params, (obs, heat), {"parts": True})
    loss = torch.mean((out - batch["actions"].float()) ** 2)
    if g["method"] == "Reg":
        g1 = heat[:, -1:]
        g2 = gaze_mask_from_latent(z, g["beta"], (d["img_height"], d["img_width"]))[:, None]
        loss = loss + g["lambda_weight"] * torch.mean((g1 - g2) ** 2)
    return loss


def gaze_model(cfg) -> UNet:
    if cfg["model"].get("arch") != "unet":
        raise NotImplementedError("reference: the UNet gaze predictor only")
    per = 1 if cfg["model"]["grayscale"] else 3
    return UNet(cfg["data"]["frame_stack"] * per, output_channels=1)


def gaze_loss(model: UNet, cfg, params, batch):
    """MSE of the prediction against the last frame's aggregated heat."""
    hm = heatmapper(cfg, gaze_cfg=True)
    obs, target, _ = hm.prepare_for_gaze_predictor(batch["obs_seq"], batch["gaze_seq"],
                                                   cfg["data"]["frame_stack"],
                                                   grayscale=cfg["model"]["grayscale"])
    pred = functional_call(model, params, (obs,))
    return torch.mean((pred - target) ** 2)


def optimizer(cfg, steps_per_epoch: int):
    return build_optimizer(cfg["optimizer"], cfg["scheduler"], cfg["training"], steps_per_epoch)
