"""Carry weights between the JAX package's flax trees and the port.

``params_from_flax`` takes the flax parameter tree of
gabril_carla_tpu.train.bc.init_bc_params as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns a state dict for
train/bc.py: BCModels; ``gaze_params_from_flax`` does the same for the gaze
predictor (AutoEncoder or UNet), ``vqvae_params_from_flax`` for the VQ-VAE
(train/vqvae.py: VQVAE), ``head_params_from_flax`` for ``mlp_head`` and
``Projector`` (models/heads.py). The maps are linear (transposes, flips and
a row permutation), so a tree of gradients converts the same way. It
imports nothing of JAX.

Each model's map is a layout: one ``(flax path, port module, kind)`` entry
a layer. The same layouts drive ``flax_init``, which draws a model's
initial parameters as flax's ``init`` draws them (utils/prng.py: each
kernel from its path's folded key), in flax's shapes, for the maps to
convert.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .models.encoder import latent_hw
from .utils import prng

RELU_GAIN = math.sqrt(2.0)  # models/encoder.py conv_init: orthogonal, torch's relu gain


def _conv(p: dict) -> dict:
    """flax Conv (kernel HWIO) -> torch Conv2d (weight OIHW)."""
    out = {"weight": np.transpose(p["kernel"], (3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _dense(p: dict) -> dict:
    """flax Dense (kernel [in, out]) -> torch Linear (weight [out, in])."""
    return {"weight": np.transpose(p["kernel"]), "bias": p["bias"]}


def _conv_t(p: dict) -> dict:
    """flax ConvTranspose (kernel HWIO, applied unflipped) -> torch
    ConvTranspose2d (weight [in, out, kh, kw], applied flipped)."""
    w = np.transpose(p["kernel"], (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return {"weight": np.ascontiguousarray(w), "bias": p["bias"]}


def _group_norm(p: dict) -> dict:
    return {"weight": p["scale"], "bias": p["bias"]}


def _codebook(p: dict) -> dict:
    return {"codebook": p["codebook"]}


# kind -> (flax leaves -> port leaves, port kernel shape -> flax kernel shape)
KINDS = {
    "conv": (_conv, lambda s: (s[2], s[3], s[1], s[0])),
    "conv_t": (_conv_t, lambda s: (s[2], s[3], s[0], s[1])),
    "dense": (_dense, lambda s: (s[1], s[0])),
    "group_norm": (_group_norm, None),
    "codebook": (_codebook, None),
}


def _residuals(path: tuple, prefix: str, n_res: int) -> list:
    out = []
    for i in range(n_res):
        res = path + ("ResidualStack_0", f"Residual_{i}")
        out += [(res + ("Conv_0",), f"{prefix}.res.layers.{i}.conv3", "conv"),
                (res + ("Conv_1",), f"{prefix}.res.layers.{i}.conv1", "conv")]
    return out


def encoder_layout(path: tuple, prefix: str, n_res: int) -> list:
    """models/encoder.py Encoder at flax ``path`` as the port's ``prefix``."""
    out = [(path + (f"Conv_{i}",), f"{prefix}.{name}", "conv")
           for i, name in enumerate(("down1", "down2", "down3", "mid", "out1", "out2"))]
    return out + _residuals(path, prefix, n_res)


def decoder_layout(path: tuple, prefix: str, n_res: int) -> list:
    out = [(path + ("Conv_0",), f"{prefix}.conv_in", "conv")] + _residuals(path, prefix, n_res)
    return out + [(path + (f"ConvTranspose_{i}",), f"{prefix}.up{i + 1}", "conv_t") for i in range(4)]


def _mlp_layout(path: tuple, prefix: str, depth: int) -> list:
    """flax heads.py MLP (Dense_0 .. Dense_depth) -> the port's MLP layers."""
    return [(path + (f"Dense_{i}",), f"{prefix}layers.{i}", "dense") for i in range(depth + 1)]


UNET_BLOCKS = ("e1", "e2", "e3", "e4", "bott", "d4", "d3", "d2", "d1")  # ConvBlock_0..8


def bc_layout(cfg) -> list:
    """train/bc.py BCModels for ``cfg``: every submodule the gaze and
    dropout methods give it, each its own flax tree (JAX bc.py:96-113)."""
    n_res = cfg.model["num_residual_layers"]
    out = encoder_layout(("encoder",), "encoder", n_res)
    out += [(("pre_actor", "Dense_0"), "pre_actor.fc", "dense"),
            (("actor", "Dense_0"), "actor.fc1", "dense"), (("actor", "Dense_1"), "actor.fc2", "dense")]
    if cfg.gaze["method"] == "AGIL":
        out += encoder_layout(("encoder_agil",), "encoder_agil", n_res)
    if cfg.gaze["method"] == "GRIL":
        out += _mlp_layout(("gril_head",), "gril_head.", 1)
    if cfg.dropout["method"] == "Oreo":
        out.append((("quantizer",), "quantizer", "codebook"))
    return out


def gaze_layout(cfg) -> list:
    """train/gaze_predictor.py's model for ``cfg.model["arch"]``."""
    if cfg.model.get("arch", "autoencoder") == "unet":
        out = []
        for i, name in enumerate(UNET_BLOCKS):
            for j in range(2):
                out += [((f"ConvBlock_{i}", f"Conv_{j}"), f"{name}.convs.{j}", "conv"),
                        ((f"ConvBlock_{i}", f"GroupNorm_{j}"), f"{name}.norms.{j}", "group_norm")]
        out += [((f"ConvTranspose_{i}",), f"up{4 - i}", "conv_t") for i in range(4)]
        return out + [(("Conv_0",), "out", "conv")]
    n_res = cfg.model["num_residual_layers"]
    return encoder_layout(("encoder",), "encoder", n_res) + decoder_layout(("decoder",), "decoder", n_res)


def vqvae_layout(cfg) -> list:
    """train/vqvae.py VQVAE: encoder, the raw codebook, decoder."""
    n_res = cfg.model["num_residual_layers"]
    return (encoder_layout(("encoder",), "encoder", n_res) + [(("quantizer",), "quantizer", "codebook")]
            + decoder_layout(("decoder",), "decoder", n_res))


def _leaf(tree: dict, path: tuple):
    for name in path:
        tree = tree[name]
    return tree


def _tensors(named: dict) -> dict:
    return {f"{mod}.{leaf}": torch.tensor(np.asarray(a, dtype=np.float32))
            for mod, leaves in named.items() for leaf, a in leaves.items()}


def from_flax(params_np: dict, layout: list) -> dict:
    """A flax tree as the port's state dict through ``layout``; a layout
    entry whose top-level tree is absent is skipped."""
    return _tensors({port: KINDS[kind][0](_leaf(params_np, path))
                     for path, port, kind in layout if path[0] in params_np})


def flatten_rows_nhwc_to_nchw(kernel: np.ndarray, channels: int, hw: tuple[int, int]) -> np.ndarray:
    """Reorder the input rows of a Dense kernel [h*w*c, out] that follows an
    NHWC flatten (flax, heads.py PreActor) of an [h, w] map so that it
    follows an NCHW flatten (the port): row (y*w + x)*c + ch moves to
    ch*h*w + y*w + x."""
    h, w = hw
    return kernel.reshape(h, w, channels, -1).transpose(2, 0, 1, 3).reshape(h * w * channels, -1)


def params_from_flax(params_np: dict, cfg) -> dict:
    # the port flattens NCHW: permute the pre-actor's input rows once here
    pre = dict(params_np["pre_actor"]["Dense_0"])
    pre["kernel"] = flatten_rows_nhwc_to_nchw(
        pre["kernel"], cfg.model["embedding_dim"], latent_hw(cfg.data["img_height"], cfg.data["img_width"]))
    return from_flax({**params_np, "pre_actor": {"Dense_0": pre}}, bc_layout(cfg))


def head_params_from_flax(params_np: dict) -> dict:
    """The flax tree of heads.py's ``mlp_head`` (an MLP) or ``Projector``
    (``{"MLP_0": ...}``) as a state dict of the port's MLP or Projector."""
    if "MLP_0" in params_np:
        return from_flax(params_np, _mlp_layout(("MLP_0",), "mlp.", len(params_np["MLP_0"]) - 1))
    return from_flax(params_np, _mlp_layout((), "", len(params_np) - 1))


def gaze_params_from_flax(params_np: dict, cfg) -> dict:
    """The flax tree of gabril_carla_tpu.train.gaze_predictor's model
    (``cfg.model["arch"]``: autoencoder or unet) as a state dict of the
    port's AutoEncoder or UNet. Linear, like params_from_flax."""
    return from_flax(params_np, gaze_layout(cfg))


def vqvae_params_from_flax(params_np: dict, cfg) -> dict:
    """The flax tree of gabril_carla_tpu.train.vqvae (encoder, decoder and
    the raw codebook) as a state dict of the port's VQVAE. Linear."""
    return from_flax(params_np, vqvae_layout(cfg))


def flax_init(layout: list, shapes: dict, roots: dict, kernel_init) -> dict:
    """The flax tree ``init`` gives the modules of ``layout``, drawn on the
    host. ``shapes`` maps the port's state-dict names to shapes (a layer
    has a bias where the port's has one). ``roots`` maps a top-level name
    to the key its own ``module.init`` took (BC's and the VQ-VAE's
    submodules, JAX bc.py:96-113, vqvae.py:36-45), or None to the key of
    one ``init`` over the whole tree (the gaze predictor). A kernel's key
    folds its path below that root and its rank 1 among the layer's
    parameters (utils/prng.py flax_fold); ``kernel_init(key, shape, kind)``
    draws it. Biases are zeros, GroupNorm scales ones, and a codebook is
    ``uniform * 2 / K`` (models/vq.py)."""
    tree: dict = {}
    for path, port, kind in layout:
        key, below = (roots[path[0]], path[1:]) if path[0] in roots else (roots[None], path)
        leaves = {}
        if kind == "group_norm":
            c = shapes[f"{port}.weight"][0]
            leaves = {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}
        elif kind == "codebook":
            k = shapes[f"{port}.codebook"][0]
            cb = prng.uniform(prng.flax_fold(key, *below, 1), shapes[f"{port}.codebook"])
            leaves = {"codebook": cb * np.float32(2.0 / k)}
        else:
            shape = KINDS[kind][1](tuple(shapes[f"{port}.weight"]))
            leaves["kernel"] = kernel_init(prng.flax_fold(key, *below, 1), shape, kind)
            if f"{port}.bias" in shapes:
                leaves["bias"] = np.zeros(shape[-1], np.float32)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = leaves
    return tree


def orthogonal_init(key, shape, kind):
    """models/encoder.py's conv_init and dense_init: orthogonal with relu
    gain for convs and transposed convs, gain 1 for dense layers."""
    return prng.orthogonal(key, shape, 1.0 if kind == "dense" else RELU_GAIN)


def lecun_init(key, shape, kind):
    """flax's default kernel init (the UNet's layers)."""
    return prng.lecun_normal(key, shape)
