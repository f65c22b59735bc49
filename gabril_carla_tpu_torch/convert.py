"""Carry BC weights from the JAX package to the port.

``params_from_flax`` takes the flax parameter tree of
gabril_carla_tpu.train.bc.init_bc_params as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns a state dict for
train/bc.py: BCModels. The maps are linear (transposes and a row
permutation), so a tree of gradients converts the same way. It imports
nothing of JAX.
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


def _encoder(enc: dict, prefix: str, n_res: int) -> dict:
    named = {f"{prefix}.{name}": _conv(enc[f"Conv_{i}"])
             for i, name in enumerate(("down1", "down2", "down3", "mid", "out1", "out2"))}
    for i in range(n_res):
        res = enc["ResidualStack_0"][f"Residual_{i}"]
        named[f"{prefix}.res.layers.{i}.conv3"] = _conv(res["Conv_0"])
        named[f"{prefix}.res.layers.{i}.conv1"] = _conv(res["Conv_1"])
    return named


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
        for i in range(2):
            named[f"gril_head.layers.{i}"] = _dense(params_np["gril_head"][f"Dense_{i}"])
    if "quantizer" in params_np:
        named["quantizer"] = {"codebook": params_np["quantizer"]["codebook"]}
    return {f"{mod}.{leaf}": torch.tensor(np.asarray(a, dtype=np.float32))
            for mod, leaves in named.items() for leaf, a in leaves.items()}
