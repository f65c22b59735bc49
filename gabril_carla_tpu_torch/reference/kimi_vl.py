"""Plain float32 reference of Kimi-VL-A3B-Instruct as the VLM labeler runs it
(models/kimi_vl.py, saliency/vlm_labeler.py), in torch alone: it imports
no kernel or module of the port and no JAX, and turns TF32 off. The
benchmark keeps a copy (drivebench/reference/kimi_vl.py).

It follows the model's equations with nothing of the port's machinery: one
sequence at a time (no batching), the full causal forward over the prompt
and the generated ids (no cache; keys and values decompressed from the
latent), attention as explicit softmax products, and each routed expert
looped over the tokens that chose it. Weights are a state dict of the
model (any dtype, any device); a layer's are upcast to float32 when it
runs, so a caller can keep them in bf16 and run many sequences layer by
layer (``vision``, ``logits``).

Departures from the published model, shared with the port:

* prompts at the token-id level: the tokenizer's and the chat template's
  files are not in the repository (saliency/vlm_labeler.py);
* a fixed number of generated ids, with no end-of-answer stop;
* the frame zero-padded to a multiple of 28 in place of the processor's
  resize;
* the RoPE pair layout: the decoder rotates adjacent pairs (2j, 2j+1) at
  frequency j, which gives the same scores as the published half-split
  layout over permuted weights; the tower's pair 2i rotates by the patch's
  column and 2i+1 by its row at frequency i.

``fault`` plants one of FAULTS, for the checks that must catch them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FAULTS = ("top5", "no_bias", "no_shared", "no_rope_k", "no_vit_rope")
LM = "language_model."


def f32_only():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32(state: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v.float() for k, v in state.items() if k.startswith(prefix)}


def _rotate(x, angles):
    """Adjacent pairs of x's last axis rotated by ``angles`` [..., d/2]."""
    a, b = x[..., 0::2], x[..., 1::2]
    c, s = torch.cos(angles), torch.sin(angles)
    out = torch.empty_like(x)
    out[..., 0::2] = a * c - b * s
    out[..., 1::2] = a * s + b * c
    return out


def _layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _rms_norm(x, w, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _attend(q, k, v, causal: bool):
    """q, k [n, heads, d], v [n, heads, dv] -> [n, heads * dv]."""
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        n = q.shape[0]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1), float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v).reshape(q.shape[0], -1)


# ----------------------------------------------------------------- vision


def pixels(frame: torch.Tensor, pad_hw) -> torch.Tensor:
    """A uint8 gray frame [H, W] -> [3, pad_h, pad_w] float32: [0, 255] to
    [-1, 1], zeros below and right of it."""
    out = torch.zeros(3, *pad_hw, device=frame.device)
    out[:, :frame.shape[0], :frame.shape[1]] = (frame.float() / 255.0 - 0.5) / 0.5
    return out


def _bicubic_table(table, h, w):
    if (h, w) == tuple(table.shape[:2]):
        return table
    return torch.nn.functional.interpolate(table.permute(2, 0, 1)[None], size=(h, w), mode="bicubic",
                                           align_corners=False)[0].permute(1, 2, 0)


def vision(state: dict, cfg: dict, images: list, fault: str | None = None) -> list:
    """Pixels [3, H, W] float32 each -> the projector's output [(H/28)(W/28),
    hidden] each."""
    f32_only()
    p, m, c = cfg["patch_size"], cfg["merge"], cfg["vit_hidden_size"]
    heads = cfg["vit_heads"]
    hd = c // heads
    pe = _f32(state, "vision_tower.patch_embed.")
    xs, grids = [], []
    for img in images:
        h, w = img.shape[1] // p, img.shape[2] // p
        patches = img.reshape(3, h, p, w, p).permute(1, 3, 0, 2, 4).reshape(h * w, 3 * p * p)
        x = patches @ pe["proj.weight"].reshape(c, -1).T + pe["proj.bias"]
        xs.append(x + _bicubic_table(pe["pos_emb.weight"], h, w).reshape(h * w, c))
        grids.append((h, w))
    freqs = cfg["vit_rope_theta"] ** (-torch.arange(0, hd, 4, dtype=torch.float64)[: hd // 4] / hd)
    for i in range(cfg["vit_layers"]):
        b = _f32(state, f"vision_tower.encoder.blocks.{i}.")
        for j, (x, (h, w)) in enumerate(zip(xs, grids)):
            rows = torch.arange(h, dtype=torch.float64).repeat_interleave(w)
            cols = torch.arange(w, dtype=torch.float64).repeat(h)
            ang = torch.stack([cols[:, None] * freqs, rows[:, None] * freqs], -1).reshape(h * w, -1)
            ang = ang.float().to(x.device)[:, None]
            y = _layer_norm(x, b["norm0.weight"], b["norm0.bias"], cfg["vit_eps"])
            qkv = (y @ b["wqkv.weight"].T + b["wqkv.bias"]).reshape(-1, 3, heads, hd)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            if fault != "no_vit_rope":
                q, k = _rotate(q, ang), _rotate(k, ang)
            x = x + _attend(q, k, v, causal=False) @ b["wo.weight"].T + b["wo.bias"]
            y = _layer_norm(x, b["norm1.weight"], b["norm1.bias"], cfg["vit_eps"])
            y = _gelu_tanh(y @ b["mlp.fc0.weight"].T + b["mlp.fc0.bias"])
            xs[j] = x + y @ b["mlp.fc1.weight"].T + b["mlp.fc1.bias"]
    f = _f32(state, "vision_tower.encoder.final_layernorm.")
    pj = _f32(state, "multi_modal_projector.")
    out = []
    for x, (h, w) in zip(xs, grids):
        x = _layer_norm(x, f["weight"], f["bias"], cfg["vit_eps"])
        x = x.reshape(h // m, m, w // m, m, c).permute(0, 2, 1, 3, 4).reshape(-1, m * m, c)
        x = _layer_norm(x, pj["pre_norm.weight"], pj["pre_norm.bias"], cfg["projector_eps"]).flatten(1)
        x = _gelu(x @ pj["linear_1.weight"].T + pj["linear_1.bias"])
        out.append(x @ pj["linear_2.weight"].T + pj["linear_2.bias"])
    return out


# ---------------------------------------------------------------- decoder


def _mla(x, a: dict, cfg: dict, fault, keep=None):
    n = x.shape[0]
    heads, nope, r, lat = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                           cfg["kv_lora_rank"])
    ang = torch.arange(n, dtype=torch.float64)[:, None] * cfg["rope_theta"] ** (
        -torch.arange(0, r, 2, dtype=torch.float64) / r)
    ang = ang.float().to(x.device)
    q = (x @ a["q_proj.weight"].T).reshape(n, heads, nope + r)
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:], ang[:, None])], -1)
    kv = x @ a["kv_a_proj_with_mqa.weight"].T
    c = _rms_norm(kv[:, :lat], a["kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_pe = kv[:, lat:] if fault == "no_rope_k" else _rotate(kv[:, lat:], ang)
    if keep is not None:
        keep.append(torch.cat([c, k_pe], -1))
    kvb = (c @ a["kv_b_proj.weight"].T).reshape(n, heads, nope + cfg["v_head_dim"])
    k = torch.cat([kvb[..., :nope], k_pe[:, None].expand(n, heads, r)], -1)
    return _attend(q, k, kvb[..., nope:], causal=True) @ a["o_proj.weight"].T


def _swiglu(x, gate_up, down):
    g, u = (x @ gate_up.T).chunk(2, -1)
    return (torch.nn.functional.silu(g) * u) @ down.T


def _moe(x, mw: dict, cfg: dict, fault, forced=None, keep=None):
    """``forced`` [n, k] puts those experts in place of the top k (their
    weights still the reference's own scores); ``keep`` gets (the experts
    used, the reference's choice scores [n, experts])."""
    scores = torch.sigmoid(x @ mw["gate.weight"].T)
    choice = scores if fault == "no_bias" else scores + mw["gate.e_score_correction_bias"]
    k = cfg["num_experts_per_tok"] - (fault == "top5")
    idx = torch.topk(choice, k, -1).indices if forced is None else forced.long()
    if keep is not None:
        keep.append((idx, choice))
    w = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        hit = idx == e
        rows = hit.any(1).nonzero()[:, 0]
        if len(rows):
            y = _swiglu(x[rows], mw["experts.gate_up_proj"][e], mw["experts.down_proj"][e])
            out[rows] += (w * hit).sum(1)[rows, None] * y
    if fault != "no_shared":
        out = out + _swiglu(x, mw["shared_experts.gate_up_proj.weight"], mw["shared_experts.down_proj.weight"])
    return out


def logits(state: dict, cfg: dict, seqs: list, fault: str | None = None, keep_cache: list | None = None,
           routes: list | None = None, keep_routes: list | None = None) -> list:
    """Each of ``seqs``, (ids [L] int64, image [n, hidden] float32,
    image_at, positions [P]): the causal forward over its ids with the image
    in place of ids image_at:image_at + n; returns the logits [P, vocab] at
    the given positions of each. ``keep_cache``, a list, gets for each
    sequence its layers' latent entries [L, kv_lora_rank + rope]: the
    normalised latent and the roped key, as a cache would hold them.

    ``routes``, for each sequence a list of each expert layer's experts [L,
    k], routes every token to those experts in place of the reference's own
    top k: a routing decision is discontinuous, and a token whose k-th and
    next scores lie within rounding of each other takes another expert in
    bf16 than in float32, which moves its later layers by tens of percent.
    ``keep_routes`` gets for each sequence a list of each expert layer's
    (experts used, choice scores)."""
    f32_only()
    eps = cfg["rms_norm_eps"]
    table = state[LM + "embed_tokens.weight"]
    xs = []
    for ids, image, at, _ in seqs:
        x = table[ids].float()
        x[at:at + image.shape[0]] = image.float()
        xs.append(x)
        if keep_cache is not None:
            keep_cache.append([])
        if keep_routes is not None:
            keep_routes.append([])
    for i in range(cfg["num_hidden_layers"]):
        lw = _f32(state, f"{LM}layers.{i}.")
        a = {k[len("self_attn."):]: v for k, v in lw.items() if k.startswith("self_attn.")}
        mw = {k[len("mlp."):]: v for k, v in lw.items() if k.startswith("mlp.")}
        for j, x in enumerate(xs):
            keep = None if keep_cache is None else keep_cache[len(keep_cache) - len(xs) + j]
            x = x + _mla(_rms_norm(x, lw["input_layernorm.weight"], eps), a, cfg, fault, keep)
            y = _rms_norm(x, lw["post_attention_layernorm.weight"], eps)
            if i < cfg["first_k_dense_replace"]:
                x = x + _swiglu(y, mw["gate_up_proj.weight"], mw["down_proj.weight"])
            else:
                m = i - cfg["first_k_dense_replace"]
                x = x + _moe(y, mw, cfg, fault, None if routes is None else routes[j][m],
                             None if keep_routes is None else keep_routes[len(keep_routes) - len(xs) + j])
            xs[j] = x
        del lw, a, mw
    norm = state[LM + "norm.weight"].float()
    head = state[LM + "lm_head.weight"].float()
    return [_rms_norm(x[pos], norm, eps) @ head.T for x, (_, _, _, pos) in zip(xs, seqs)]


# ----------------------------------------------------------- the labeler


def prompt_ids(template, image_at: int, n_image: int, boxes, layout: dict, frame_hw, max_boxes: int,
               max_depth: float, class_colors) -> tuple:
    """One world's prompt from its scene boxes [A, 8] (u0 u1 v0 v1 depth
    color ok pad): (ids [L] int64, listed boxes [K, 4] x0 y0 x1 y1 clipped
    to the frame)."""
    h, w = frame_hw
    ok = (boxes[:, 6] > 0.5) & (boxes[:, 4] < max_depth)
    kept = ok.nonzero()[:, 0]
    kept = kept[torch.sort(boxes[kept, 4], stable=True).indices][:max_boxes]
    sel = boxes[kept]
    hi = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=sel.dtype, device=sel.device)
    xyxy = torch.minimum(sel[:, [0, 2, 1, 3]].clamp_min(0.0), hi)
    bins = torch.round(xyxy / hi * 999).long()
    colors = torch.tensor(class_colors, dtype=sel.dtype, device=sel.device)
    cls = (sel[:, 5:6] - colors).abs().argmin(-1)
    ids = [template[:image_at], torch.full((n_image,), layout["image"], device=template.device),
           template[image_at:]]
    for b in range(len(kept)):
        ids.append(torch.cat([torch.tensor([layout["open"], layout["class0"] + int(cls[b])], device=template.device),
                              layout["coord0"] + bins[b], torch.tensor([layout["close"]], device=template.device)]))
    return torch.cat(ids), xyxy


def route_shortfall(kept: list, k: int) -> float:
    """Over (experts used, choice scores) pairs (``keep_routes``), the most
    that a used expert's choice score falls below the k-th best score of its
    token; infinite where a token used other than k experts."""
    worst = 0.0
    for idx, choice in kept:
        if idx.shape[1] != k:
            return float("inf")
        kth = torch.topk(choice, k, -1).values[:, -1]
        worst = max(worst, float((kth - choice.gather(1, idx).min(1).values).clamp_min(0).max()))
    return worst


def parse_coords(generated: np.ndarray, boxes: np.ndarray, box0: int, frame_hw, points: int) -> np.ndarray:
    """One world's answer ids and listed boxes [K, 4] -> [2 * points]
    float32: the first ``points`` distinct ids that name a listed box, their
    centres over (W - 1, H - 1) (a set whose coordinates all lie within 1.5
    is taken as normalised already), clipped to [0, 1], -1 after."""
    h, w = frame_hw
    picks = []
    for i in np.asarray(generated) - box0:
        if 0 <= i < len(boxes) and int(i) not in picks and len(picks) < points:
            picks.append(int(i))
    out = np.full((points, 2), -1.0, np.float32)
    if picks:
        b = np.asarray(boxes, np.float32)[picks]
        c = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2], 1)
        c = c[(c[:, 0] >= 0) & (c[:, 1] >= 0)]
        if len(c) and c.max() > 1.5:
            c = c / np.asarray([w - 1, h - 1], np.float32)
        out[:len(c)] = np.clip(c, 0.0, 1.0)
    return out.reshape(-1)
