"""Carry a BC policy's weights from the JAX package to the port.

``params_from_flax`` takes the flax parameter tree of
gabril_carla_tpu.train.bc.init_bc_params as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns a state dict for
train/bc.py: BCPolicy. It imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .train.bc import LATENT_HW


def _conv(p: dict) -> dict:
    """flax Conv (kernel HWIO) -> torch Conv2d (weight OIHW)."""
    out = {"weight": np.transpose(p["kernel"], (3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _dense(p: dict) -> dict:
    """flax Dense (kernel [in, out]) -> torch Linear (weight [out, in])."""
    return {"weight": np.transpose(p["kernel"]), "bias": p["bias"]}


def flatten_rows_nhwc_to_nchw(kernel: np.ndarray, channels: int) -> np.ndarray:
    """Reorder the input rows of a Dense kernel [h*w*c, out] that follows an
    NHWC flatten (flax, heads.py PreActor) so that it follows an NCHW flatten
    (the port): row (y*w + x)*c + ch moves to ch*h*w + y*w + x."""
    h, w = LATENT_HW
    return kernel.reshape(h, w, channels, -1).transpose(2, 0, 1, 3).reshape(h * w * channels, -1)


def params_from_flax(params_np: dict, cfg) -> dict:
    enc = params_np["encoder"]
    named = {
        "encoder.down1": _conv(enc["Conv_0"]),
        "encoder.down2": _conv(enc["Conv_1"]),
        "encoder.down3": _conv(enc["Conv_2"]),
        "encoder.mid": _conv(enc["Conv_3"]),
        "encoder.out1": _conv(enc["Conv_4"]),
        "encoder.out2": _conv(enc["Conv_5"]),
        "actor.fc1": _dense(params_np["actor"]["Dense_0"]),
        "actor.fc2": _dense(params_np["actor"]["Dense_1"]),
    }
    for i in range(cfg.model["num_residual_layers"]):
        res = enc["ResidualStack_0"][f"Residual_{i}"]
        named[f"encoder.res.layers.{i}.conv3"] = _conv(res["Conv_0"])
        named[f"encoder.res.layers.{i}.conv1"] = _conv(res["Conv_1"])
    # the port flattens NCHW: permute the pre-actor's input rows once here
    pre = dict(params_np["pre_actor"]["Dense_0"])
    pre["kernel"] = flatten_rows_nhwc_to_nchw(pre["kernel"], cfg.model["embedding_dim"])
    named["pre_actor.fc"] = _dense(pre)
    return {f"{mod}.{leaf}": torch.tensor(np.asarray(a, dtype=np.float32))
            for mod, leaves in named.items() for leaf, a in leaves.items()}
