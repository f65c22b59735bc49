"""Convolution and matrix-product FLOPs of a train step and of an eval
tick, counted from the shapes, by the precision each product runs in.

Two FLOPs a multiply-add. A product's backward costs its forward twice
(the input's gradient and the weights'), except where the input needs no
gradient: the first layer's input is data, and the heat maps' resize and
splat matrices are constants. Elementwise work, norms, pooling and the
render are not counted. Covered: the BC policy of gaze methods None, Reg
and Mask with dropout None (models/encoder.py, models/heads.py; Reg's
saliency resize, ops/gaze.py), the UNet gaze predictor (models/unet.py),
and the float32 heat maps of the batch (ops/heatmap.py's splat and
alpha-decay mix).

Each function returns ``{"bf16": flops, "f32": flops}``.
"""

from __future__ import annotations


def _out(n: int, k: int, s: int = 1, p: int = 0) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(cin: int, cout: int, k: int, oh: int, ow: int) -> int:
    return 2 * cin * cout * k * k * oh * ow


def _precision(cfg) -> str:
    return "bf16" if cfg["training"]["compute_dtype"] == "bfloat16" else "f32"


def _check(cfg):
    if cfg["gaze"]["method"] not in ("None", "Reg", "Mask") or cfg["dropout"]["method"] != "None":
        raise NotImplementedError(f"no count for gaze {cfg['gaze']['method']!r} / "
                                  f"dropout {cfg['dropout']['method']!r}")


def latent_hw(cfg) -> tuple[int, int]:
    h, w = cfg["data"]["img_height"], cfg["data"]["img_width"]
    for _ in range(3):
        h, w = _out(h, 4, 2, 1), _out(w, 4, 2, 1)
    return _out(h, 3), _out(w, 3)


def policy_layers(cfg) -> list[int]:
    """Forward FLOPs a sample of each product of the BC policy, in order."""
    _check(cfg)
    m, d = cfg["model"], cfg["data"]
    nh, emb, z = m["num_hiddens"], m["embedding_dim"], m["z_dim"]
    cin = d["frame_stack"] * (1 if m["grayscale"] else 3)
    h, w = d["img_height"], d["img_width"]
    out = []
    for ci, co in ((cin, nh // 4), (nh // 4, nh // 2), (nh // 2, nh)):
        h, w = _out(h, 4, 2, 1), _out(w, 4, 2, 1)
        out.append(_conv(ci, co, 4, h, w))
    h, w = _out(h, 3), _out(w, 3)
    out.append(_conv(nh, nh, 3, h, w))
    for _ in range(m["num_residual_layers"]):
        out += [_conv(nh, m["num_residual_hiddens"], 3, h, w), _conv(m["num_residual_hiddens"], nh, 1, h, w)]
    out += [_conv(nh, nh, 5, h, w), _conv(nh, emb, 5, h, w)]
    out += [2 * emb * h * w * z, 2 * z * z, 2 * z * d["action_dim"]]
    return out


def unet_layers(cfg) -> list[int]:
    """Forward FLOPs a sample of each product of the UNet, in order."""
    d, m = cfg["data"], cfg["model"]
    cin = d["frame_stack"] * (1 if m["grayscale"] else 3)
    sizes = [(d["img_height"], d["img_width"])]
    for _ in range(4):  # max pools, floored
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    out = []
    chans = [(cin, 8), (8, 16), (16, 16), (16, 32), (32, 32)]  # e1-e4, bottleneck
    for (ci, co), (h, w) in zip(chans, sizes):
        out += [_conv(ci, co, 3, h, w), _conv(co, co, 3, h, w)]
    ups = [(32, 32, 64, 32), (32, 16, 32, 16), (16, 16, 32, 16), (16, 8, 16, 8)]  # up, then block
    for lvl, (ui, uo, bi, bo) in zip((4, 3, 2, 1), ups):
        hi, wi = sizes[lvl]  # the transposed conv's input grid
        h, w = sizes[lvl - 1]
        out += [_conv(ui, uo, 2, hi, wi), _conv(bi, bo, 3, h, w), _conv(bo, bo, 3, h, w)]
    h, w = sizes[0]
    out.append(_conv(8, 1, 1, h, w))
    return out


def heat_maps(cfg) -> int:
    """Float32 FLOPs a sample of the batch's aggregated heat: a splat of P
    points for each of S frames and the S x S alpha-decay mix."""
    d, g = cfg["data"], cfg["gaze"]
    h, w, s = d["img_height"], d["img_width"], d["frame_stack"]
    return s * 2 * h * g["max_points"] * w + 2 * s * s * h * w


def saliency_resize(cfg) -> int:
    """Float32 FLOPs a sample of Reg's bicubic resize of the latent's
    saliency to the frame (two matrix products)."""
    h, w = latent_hw(cfg)
    big_h, big_w = cfg["data"]["img_height"], cfg["data"]["img_width"]
    return 2 * big_h * h * w + 2 * big_h * w * big_w


def _train(layers: list[int]) -> int:
    return 3 * sum(layers) - layers[0]


def bc_train_step(cfg, batch: int) -> dict:
    """One BC step on ``batch`` samples: the policy forward and backward,
    the batch's heat maps, and Reg's resize forward and backward."""
    f32 = heat_maps(cfg) + (2 * saliency_resize(cfg) if cfg["gaze"]["method"] == "Reg" else 0)
    out = {"bf16": 0, "f32": batch * f32}
    out[_precision(cfg)] += batch * _train(policy_layers(cfg))
    return out


def gaze_train_step(gaze_cfg, batch: int) -> dict:
    """One UNet step on ``batch`` samples: forward and backward, and the
    target's heat maps."""
    out = {"bf16": 0, "f32": batch * heat_maps(gaze_cfg)}
    out[_precision(gaze_cfg)] += batch * _train(unet_layers(gaze_cfg))
    return out


def eval_tick(cfg, gaze_cfg, worlds: int) -> dict:
    """One closed-loop tick of ``worlds`` worlds: the policy forward, and
    the UNet's forward where the heat comes from it."""
    out = {"bf16": 0, "f32": 0}
    out[_precision(cfg)] += worlds * sum(policy_layers(cfg))
    if gaze_cfg is not None:
        out[_precision(gaze_cfg)] += worlds * sum(unet_layers(gaze_cfg))
    return out
