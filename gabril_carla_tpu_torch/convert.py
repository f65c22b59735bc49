"""Carry weights from the JAX package to the port.

``params_from_flax`` takes the flax parameter tree of
gabril_carla_tpu.train.bc.init_bc_params as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns a state dict for
train/bc.py: BCModels; ``gaze_params_from_flax`` does the same for the gaze
predictor (AutoEncoder or UNet), ``vqvae_params_from_flax`` for the VQ-VAE
(train/vqvae.py: VQVAE), ``head_params_from_flax`` for ``mlp_head`` and
``Projector`` (models/heads.py). The maps are linear (transposes, flips and
a row permutation), so a tree of gradients converts the same way. It
imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.encoder import latent_hw


def _conv(p: dict) -> dict:
    """flax Conv (kernel HWIO) -> torch Conv2d (weight OIHW)."""
    out = {"weight": np.transpose(p["kernel"], (3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _dense(p: dict) -> dict:
    """flax Dense (kernel [in, out]) -> torch Linear (weight [out, in])."""
    return {"weight": np.transpose(p["kernel"]), "bias": p["bias"]}


def _mlp(tree: dict, prefix: str) -> dict:
    """flax heads.py MLP (Dense_0 .. Dense_n) -> the port's MLP layers."""
    return {f"{prefix}layers.{i}": _dense(tree[f"Dense_{i}"]) for i in range(len(tree))}


def head_params_from_flax(params_np: dict) -> dict:
    """The flax tree of heads.py's ``mlp_head`` (an MLP) or ``Projector``
    (``{"MLP_0": ...}``) as a state dict of the port's MLP or Projector."""
    if "MLP_0" in params_np:
        return _tensors(_mlp(params_np["MLP_0"], "mlp."))
    return _tensors(_mlp(params_np, ""))


def _conv_t(p: dict) -> dict:
    """flax ConvTranspose (kernel HWIO, applied unflipped) -> torch
    ConvTranspose2d (weight [in, out, kh, kw], applied flipped)."""
    w = np.transpose(p["kernel"], (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return {"weight": np.ascontiguousarray(w), "bias": p["bias"]}


def _residuals(stack: dict, prefix: str, n_res: int) -> dict:
    named = {}
    for i in range(n_res):
        res = stack[f"Residual_{i}"]
        named[f"{prefix}.res.layers.{i}.conv3"] = _conv(res["Conv_0"])
        named[f"{prefix}.res.layers.{i}.conv1"] = _conv(res["Conv_1"])
    return named


def _encoder(enc: dict, prefix: str, n_res: int) -> dict:
    named = {f"{prefix}.{name}": _conv(enc[f"Conv_{i}"])
             for i, name in enumerate(("down1", "down2", "down3", "mid", "out1", "out2"))}
    named.update(_residuals(enc["ResidualStack_0"], prefix, n_res))
    return named


def _decoder(dec: dict, prefix: str, n_res: int) -> dict:
    named = {f"{prefix}.conv_in": _conv(dec["Conv_0"])}
    named.update(_residuals(dec["ResidualStack_0"], prefix, n_res))
    for i in range(4):
        named[f"{prefix}.up{i + 1}"] = _conv_t(dec[f"ConvTranspose_{i}"])
    return named


UNET_BLOCKS = ("e1", "e2", "e3", "e4", "bott", "d4", "d3", "d2", "d1")  # ConvBlock_0..8


def _tensors(named: dict) -> dict:
    return {f"{mod}.{leaf}": torch.tensor(np.asarray(a, dtype=np.float32))
            for mod, leaves in named.items() for leaf, a in leaves.items()}


def gaze_params_from_flax(params_np: dict, cfg) -> dict:
    """The flax tree of gabril_carla_tpu.train.gaze_predictor's model
    (``cfg.model["arch"]``: autoencoder or unet) as a state dict of the
    port's AutoEncoder or UNet. Linear, like params_from_flax."""
    if cfg.model.get("arch", "autoencoder") == "unet":
        named = {}
        for i, name in enumerate(UNET_BLOCKS):
            blk = params_np[f"ConvBlock_{i}"]
            for j in range(2):
                named[f"{name}.convs.{j}"] = _conv(blk[f"Conv_{j}"])
                gn = blk[f"GroupNorm_{j}"]
                named[f"{name}.norms.{j}"] = {"weight": gn["scale"], "bias": gn["bias"]}
        for i in range(4):
            named[f"up{4 - i}"] = _conv_t(params_np[f"ConvTranspose_{i}"])
        named["out"] = _conv(params_np["Conv_0"])
        return _tensors(named)
    n_res = cfg.model["num_residual_layers"]
    named = _encoder(params_np["encoder"], "encoder", n_res)
    named.update(_decoder(params_np["decoder"], "decoder", n_res))
    return _tensors(named)


def vqvae_params_from_flax(params_np: dict, cfg) -> dict:
    """The flax tree of gabril_carla_tpu.train.vqvae (encoder, decoder and
    the raw codebook) as a state dict of the port's VQVAE. Linear."""
    n_res = cfg.model["num_residual_layers"]
    named = _encoder(params_np["encoder"], "encoder", n_res)
    named.update(_decoder(params_np["decoder"], "decoder", n_res))
    named["quantizer"] = {"codebook": params_np["quantizer"]["codebook"]}
    return _tensors(named)


def flatten_rows_nhwc_to_nchw(kernel: np.ndarray, channels: int, hw: tuple[int, int]) -> np.ndarray:
    """Reorder the input rows of a Dense kernel [h*w*c, out] that follows an
    NHWC flatten (flax, heads.py PreActor) of an [h, w] map so that it
    follows an NCHW flatten (the port): row (y*w + x)*c + ch moves to
    ch*h*w + y*w + x."""
    h, w = hw
    return kernel.reshape(h, w, channels, -1).transpose(2, 0, 1, 3).reshape(h * w * channels, -1)


def params_from_flax(params_np: dict, cfg) -> dict:
    n_res = cfg.model["num_residual_layers"]
    named = _encoder(params_np["encoder"], "encoder", n_res)
    named["actor.fc1"] = _dense(params_np["actor"]["Dense_0"])
    named["actor.fc2"] = _dense(params_np["actor"]["Dense_1"])
    # the port flattens NCHW: permute the pre-actor's input rows once here
    pre = dict(params_np["pre_actor"]["Dense_0"])
    pre["kernel"] = flatten_rows_nhwc_to_nchw(
        pre["kernel"], cfg.model["embedding_dim"], latent_hw(cfg.data["img_height"], cfg.data["img_width"]))
    named["pre_actor.fc"] = _dense(pre)
    if "encoder_agil" in params_np:
        named.update(_encoder(params_np["encoder_agil"], "encoder_agil", n_res))
    if "gril_head" in params_np:
        named.update(_mlp(params_np["gril_head"], "gril_head."))
    if "quantizer" in params_np:
        named["quantizer"] = {"codebook": params_np["quantizer"]["codebook"]}
    return _tensors(named)
