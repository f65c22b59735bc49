"""Gaze-predictor training: stacked frames -> the aggregated gaze heatmap
(port of gabril_carla_tpu/train/gaze_predictor.py).

Parity: vlm_gaze/train/train_gaze_predictor.py:83-101 (MSE of the float32
prediction against the last step's causally aggregated heatmap). The trained
model is frozen at eval to supply heat for ViSaRL/Mask/AGIL/GMD/IGMD
(eval/my_agents/bc_agent.py:83-94; here eval/agent.py).

Parameters are a flat state dict of the model, applied with
``torch.func.functional_call``; NCHW throughout.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from ..convert import flax_init, gaze_layout, gaze_params_from_flax, lecun_init, orthogonal_init
from ..models.encoder import AutoEncoder
from ..models.unet import UNet
from ..ops.heatmap import GazeHeatmapper
from ..ops.unet_kernel import unet_forward
from .bc import _dtype, full_f32
from ..parallel.mesh import pmean
from ..utils.profiling import span
from .optim import TrainState


def build_gaze_models(cfg, device="cuda"):
    """(model on ``device``, heatmapper). ``model.arch`` picks the backbone:
    'autoencoder' (the reference's configured choice,
    train_gaze_predictor.py:45) or 'unet' (models/gaze_predictor.py:6-78)."""
    full_f32()
    m = cfg.model
    dt = _dtype(cfg)
    in_ch = cfg.data["frame_stack"] * (1 if m["grayscale"] else 3)
    arch = m.get("arch", "autoencoder")
    if arch == "unet":
        model = UNet(in_ch, output_channels=1, dtype=dt)
    elif arch == "autoencoder":
        model = AutoEncoder(in_ch, m["embedding_dim"], m["num_hiddens"], m["num_residual_layers"],
                            m["num_residual_hiddens"], out_channels=1, dtype=dt)
    else:
        raise ValueError(f"unknown gaze predictor arch {arch!r} "
                         "(expected 'autoencoder' or 'unet')")
    g = cfg.gaze
    heatmapper = GazeHeatmapper(
        img_height=cfg.data["img_height"],
        img_width=cfg.data["img_width"],
        gaze_sigma=g.get("sigma", g.get("mask_sigma", 30.0)),
        gaze_coeff=g.get("coeff", g.get("mask_coeff", 0.8)),
        maxpoints=g["max_points"],
        temporal_alpha=g.get("temporal_alpha", 0.7),
        temporal_mode=g.get("temporal_mode", "alpha_decay"),
        temporal_sigmas=g.get("temporal_sigmas"),
        temporal_coeffs=g.get("temporal_coeffs"),
        temporal_offset_start=g.get("temporal_offset_start", 0),
    )
    return model.to(device), heatmapper


def init_gaze_params(model: nn.Module, cfg, key) -> dict:
    """The JAX package's ``model.init(key, ...)`` (gaze_predictor.py:61):
    each kernel from its flax path's key (convert.flax_init); the
    AutoEncoder's convs and transposed convs orthogonal with relu gain over
    flax's [kh*kw*in, out] kernel, the UNet's flax's default lecun-normal
    (truncated, fan in); zero biases, GroupNorm scales 1. Drawn on the
    host, copied into ``model`` in place. Returns the state dict."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    init = lecun_init if cfg.model.get("arch", "autoencoder") == "unet" else orthogonal_init
    model.load_state_dict(gaze_params_from_flax(flax_init(gaze_layout(cfg), shapes, {None: key}, init), cfg))
    return model.state_dict()


def init_gaze_state(cfg, key, tx, device="cuda"):
    """((model, heatmapper), TrainState) with a copy of the params from
    ``key``."""
    model, heatmapper = build_gaze_models(cfg, device)
    params = {k: v.detach().clone() for k, v in init_gaze_params(model, cfg, key).items()}
    return (model, heatmapper), TrainState.create(params, tx)


def gaze_loss_fn(params, model: nn.Module, heatmapper: GazeHeatmapper, cfg, batch):
    """MSE of the float32 prediction against prepare_for_gaze_predictor's
    target -> (loss, {"loss": loss})."""
    with span("train.heat_prep"):
        obs, target, _ = heatmapper.prepare_for_gaze_predictor(
            batch["obs_seq"], batch["gaze_seq"], frame_stack=cfg.data["frame_stack"],
            grayscale=cfg.model["grayscale"])
    pred = functional_call(model, params, (obs,)).float()
    loss = torch.mean((pred - target) ** 2)
    return loss, {"loss": loss}


def gaze_loss_and_grads(model, heatmapper, cfg, params: dict, batch):
    """(loss, metrics, grads) of gaze_loss_fn; grads a dict like ``params``."""
    with span("train.forward"):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, metrics = gaze_loss_fn(live, model, heatmapper, cfg, batch)
    with span("train.backward"):
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_gaze_train_step(model: nn.Module, heatmapper: GazeHeatmapper, cfg, group=None):
    """(state, batch, rng) -> (new state, metrics). The step draws nothing;
    ``rng`` is accepted for the epoch loop's sake and ignored. With a
    process ``group``, gradients and metrics are averaged over it before
    the optimizer (JAX gaze_predictor.py:85-87)."""

    def step(state: TrainState, batch, rng=None):
        with span("train.step"):
            _, metrics, grads = gaze_loss_and_grads(model, heatmapper, cfg, state.params, batch)
            if group is not None:
                with span("train.allreduce"):
                    grads, metrics = pmean((grads, metrics), group)
            with span("train.optimizer"):
                return state.apply_gradients(grads), metrics

    return step


def make_gaze_predictor_apply(model: nn.Module):
    """The frozen predictor as the rollout calls it: (params, obs [B, H, W,
    S] NHWC) -> [B, H, W, 1] in the model's compute dtype. A bf16 UNet on
    CUDA tensors runs ops/unet_kernel.py's kernels; every other case (the
    AutoEncoder, a float32 UNet, CPU tensors) the module's forward."""
    fused = isinstance(model, UNet) and model.dtype == torch.bfloat16

    def apply(params, obs):
        if fused and obs.is_cuda:
            return unet_forward(model, params, obs)
        return functional_call(model, params, (obs.permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)

    return apply
