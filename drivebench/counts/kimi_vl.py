"""Work of the Kimi-VL labeler's tick (drivebench/drivers/label.py), counted
from shapes: the matrix and attention FLOPs of the vision tower and
projector, the prefill and the decode steps, and the least time of the
routed experts' grouped products.

``cfg`` is a dict of the model's sizes (models/kimi_vl.py KimiVLConfig's
fields). Attention counts what causal masking needs: a prompt of L tokens
scores L(L+1)/2 pairs a head; a decode step at cache length S scores S.
"""

from __future__ import annotations

from .peaks import BF16_S, BYTES_S

BF16_BYTES = 2


def vision_flops(cfg: dict, h: int, w: int) -> float:
    """One padded image of h x w pixels through the tower and projector."""
    p, c, i = cfg["patch_size"], cfg["vit_hidden_size"], cfg["vit_intermediate_size"]
    n = (h // p) * (w // p)
    merged = n // cfg["merge"] ** 2
    wide = c * cfg["merge"] ** 2
    layer = 2 * n * c * (3 * c + c + 2 * i) + 2 * 2 * n * n * c
    return (2 * n * 3 * p * p * c + cfg["vit_layers"] * layer
            + 2 * merged * wide * (wide + cfg["hidden_size"]))


def _token_flops(cfg: dict) -> tuple[float, float, float]:
    """(attention projections, dense MLP, one MoE layer) FLOPs a token,
    without attention's scores."""
    hd, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, r, v, lat = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    proj = 2 * hd * (nh * (nope + r) + lat + r) + 2 * lat * nh * (nope + v) + 2 * nh * v * hd
    dense = 6 * hd * cfg["intermediate_size"]
    i = cfg["moe_intermediate_size"]
    moe = (2 * hd * cfg["n_routed_experts"] + 6 * hd * i * cfg["num_experts_per_tok"]
           + 6 * hd * i * cfg["n_shared_experts"])
    return proj, dense, moe


def _layers(cfg: dict) -> tuple[int, int]:
    dense = cfg["first_k_dense_replace"]
    return dense, cfg["num_hidden_layers"] - dense


def prefill_flops(cfg: dict, lengths) -> float:
    """Prompts of the given lengths, logits at each prompt's last token."""
    proj, dense, moe = _token_flops(cfg)
    n_dense, n_moe = _layers(cfg)
    nh, qk, v = cfg["num_attention_heads"], cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    tokens = sum(lengths)
    pairs = sum(L * (L + 1) // 2 for L in lengths)
    per_layer = tokens * proj + 2 * nh * (qk + v) * pairs
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"] * len(lengths)
    return cfg["num_hidden_layers"] * per_layer + tokens * (n_dense * dense + n_moe * moe) + head


def decode_flops(cfg: dict, lengths, steps: int) -> float:
    """``steps`` absorbed decode steps of one token a world after prompts of
    the given lengths (step s attends over L + s + 1 cached tokens)."""
    proj, dense, moe = _token_flops(cfg)
    n_dense, n_moe = _layers(cfg)
    nh, nope, r, v, lat = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                           cfg["v_head_dim"], cfg["kv_lora_rank"])
    absorb = 2 * nh * nope * lat + 2 * nh * lat * v  # the query's and the output's up-projections
    token = (cfg["num_hidden_layers"] * (proj + absorb) + n_dense * dense + n_moe * moe
             + 2 * cfg["hidden_size"] * cfg["vocab_size"])
    cached = sum(L + s + 1 for L in lengths for s in range(steps))
    return steps * len(lengths) * token + cfg["num_hidden_layers"] * 2 * nh * (lat + r + lat) * cached


def grouped_bound_s(cfg: dict, pairs: float, experts: float | None = None) -> float:
    """The least seconds of one expert layer's two grouped products over
    ``pairs`` token-expert pairs that reach ``experts`` experts (all by
    default): each the larger of its FLOPs at the bf16 peak and its bytes
    at the HBM rate (each reached expert's weights read once, the sorted
    rows read once and the results written once, bf16)."""
    hd, i = cfg["hidden_size"], cfg["moe_intermediate_size"]
    e = cfg["n_routed_experts"] if experts is None else experts
    gate_up = max(4 * pairs * hd * i / BF16_S, BF16_BYTES * (e * 2 * i * hd + pairs * (hd + 2 * i)) / BYTES_S)
    down = max(2 * pairs * hd * i / BF16_S, BF16_BYTES * (e * hd * i + pairs * (i + hd)) / BYTES_S)
    return gate_up + down


def moe_bound_s(cfg: dict, prefill_tokens: int, pairs: int, experts_hit: int, ticks: int, steps: int) -> dict:
    """The least seconds of the grouped products of ``ticks`` labeled ticks
    from the counters: ``pairs`` routed in all (``moe_pairs``), of which
    top-k times ``prefill_tokens`` (``label_prefill_tokens``) a layer in
    the prefills, the rest spread evenly over the ticks' decode steps; and
    ``experts_hit``, the experts that got any pair summed over layer calls
    (``moe_experts_hit``), of which a prefill's reach every expert.
    {"prefill", "decode", "all"}."""
    _, n_moe = _layers(cfg)
    k, e = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    pre = k * prefill_tokens
    dec = pairs - n_moe * pre
    calls = n_moe * ticks * steps
    out = {"prefill": n_moe * ticks * grouped_bound_s(cfg, pre / ticks),
           "decode": calls * grouped_bound_s(cfg, dec / calls, (experts_hit - n_moe * ticks * e) / calls)}
    out["all"] = out["prefill"] + out["decode"]
    return out
