"""Kimi-VL-A3B-Instruct (moonshotai/Kimi-VL-A3B-Instruct): the MoonViT vision
tower, its patch-merging projector and the DeepSeek-V3-layout decoder, in
bf16 on the card. It has no counterpart in the JAX package; it is the VLM
that turns detector boxes into pseudo-gaze (saliency/vlm_labeler.py), as
the reference's Qwen2.5-VL filter does (saliency_pipeline/vlm_filter.py).

Decoder (the published config.json): 27 layers at hidden 2,048; latent
attention (MLA) with 16 heads, no query compression, a 512-wide key-value
latent and nope/rope/v head dims 128/64/128, RoPE theta 800,000; layer 0 a
dense SwiGLU of width 11,264, layers 1-26 64 routed experts of width 1,408
(top 6 by sigmoid score plus a correction bias, the chosen scores
renormalised and scaled by 2.446) beside 2 shared experts; RMSNorm eps
1e-5; an untied 163,840-row vocabulary.

Vision (the Kimi-VL report, arXiv:2504.07491 §2: MoonViT from
SigLIP-SO400M/14; the sizes are assumed, the config's row has none):
14-pixel patches, 27 pre-LN layers of width 1,152 with 16 heads of 72, a
GELU-tanh MLP of 4,304, biases on every linear; a learned 64x64 position
table interpolated bicubically to the patch grid; 2D RoPE on q and k
(theta 10,000; pair 2i rotates by the patch's column, pair 2i+1 by its
row, at frequency i); a final LayerNorm, then 2x2 patches merged into one
token of 4,608 that the projector (LayerNorm per patch, Linear, GELU,
Linear) maps to the decoder's width.

A batch is ragged: the prompts of one call are packed into one token axis
(``Packed``). Prefill decompresses the latent into keys and values and runs
SDPA over the prompts padded to the longest; it leaves each layer's
normalised latent and roped key in a ``LatentCache`` of 576 a token.
Decode is absorbed: the query's nope part goes through the latent's key
up-projection, attends over the cache directly, and the latent result goes
through the value up-projection. The routed experts run as two grouped
products over the token-expert pairs sorted by expert (``torch._grouped_mm``,
gate and up fused, then down), weighted and scattered back into token
order; a CUDA tensor takes that call or raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span, tally

INIT_STD = 0.02  # every linear, embedding and position table: N(0, 0.02^2)


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    n_group: int = 1
    topk_group: int = 1
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    # the vision tower and projector (assumed)
    patch_size: int = 14
    vit_hidden_size: int = 1152
    vit_layers: int = 27
    vit_heads: int = 16
    vit_intermediate_size: int = 4304
    vit_pos_grid: int = 64
    vit_rope_theta: float = 10000.0
    vit_eps: float = 1e-6
    merge: int = 2
    projector_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: dict) -> "KimiVLConfig":
        """From a config.json-like dict; the vision keys may sit under
        ``assumed.vision`` (a top-level key wins). Refuses what this model
        does not implement."""
        flat = {**d.get("assumed", {}).get("vision", {}), **d}
        cfg = cls(**{f.name: flat[f.name] for f in dataclasses.fields(cls) if f.name in flat})
        if cfg.q_lora_rank is not None or cfg.n_group != 1 or cfg.topk_group != 1:
            raise ValueError("only q_lora_rank null and one routing group are implemented")
        if d.get("rope_scaling") is not None or d.get("scoring_func", "sigmoid") != "sigmoid":
            raise ValueError("only unscaled RoPE and sigmoid routing are implemented")
        return cfg

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def merged_width(self) -> int:
        return self.vit_hidden_size * self.merge ** 2


def rope_pairs(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the adjacent pairs (2j, 2j+1) of ``x``'s last axis by
    ``angles[..., j]`` (broadcast against x's leading axes), in float32."""
    xf = x.float().unflatten(-1, (-1, 2))
    cos, sin = angles.cos(), angles.sin()
    a, b = xf[..., 0], xf[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], -1).flatten(-2).to(x.dtype)


def rope_angles(pos: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """[..., dim/2] angles of 1D RoPE at integer positions ``pos``."""
    inv = theta ** (-torch.arange(0, dim, 2, device=pos.device, dtype=torch.float32) / dim)
    return pos.float()[..., None] * inv


def vit_rope_angles(h: int, w: int, dim: int, theta: float, device) -> torch.Tensor:
    """[h*w, dim/2] angles of the tower's 2D RoPE, patches row-major: pair
    2i by the column, pair 2i+1 by the row, both at theta^(-4i/dim)."""
    freqs = theta ** (-torch.arange(0, dim, 4, device=device, dtype=torch.float32)[: dim // 4] / dim)
    rows, cols = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    ax = cols.flatten().float()[:, None] * freqs
    ay = rows.flatten().float()[:, None] * freqs
    return torch.stack([ax, ay], -1).flatten(1)


class RMSNorm(nn.Module):
    def __init__(self, n: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * y.to(x.dtype)


# ----------------------------------------------------------------- vision


class PatchEmbed(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.vit_hidden_size, cfg.patch_size, cfg.patch_size)
        self.pos_emb = nn.Module()
        self.pos_emb.weight = nn.Parameter(torch.empty(cfg.vit_pos_grid, cfg.vit_pos_grid, cfg.vit_hidden_size))

    def forward(self, pixels):
        x = self.proj(pixels)  # [B, C, h, w]
        h, w = x.shape[-2:]
        table = self.pos_emb.weight
        if (h, w) != tuple(table.shape[:2]):
            table = F.interpolate(table.permute(2, 0, 1)[None].float(), size=(h, w), mode="bicubic",
                                  align_corners=False)[0].permute(1, 2, 0).to(x.dtype)
        return x.flatten(2).transpose(1, 2) + table.flatten(0, 1), (h, w)


class VisionMLP(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.fc0 = nn.Linear(cfg.vit_hidden_size, cfg.vit_intermediate_size)
        self.fc1 = nn.Linear(cfg.vit_intermediate_size, cfg.vit_hidden_size)

    def forward(self, x):
        return self.fc1(F.gelu(self.fc0(x), approximate="tanh"))


class VisionBlock(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        c = cfg.vit_hidden_size
        self.heads = cfg.vit_heads
        self.norm0 = nn.LayerNorm(c, eps=cfg.vit_eps)
        self.wqkv = nn.Linear(c, 3 * c)
        self.wo = nn.Linear(c, c)
        self.norm1 = nn.LayerNorm(c, eps=cfg.vit_eps)
        self.mlp = VisionMLP(cfg)

    def forward(self, x, angles):
        b, n, c = x.shape
        qkv = self.wqkv(self.norm0(x)).view(b, n, 3, self.heads, c // self.heads)
        q, k, v = (rope_pairs(qkv[:, :, 0], angles[:, None]), rope_pairs(qkv[:, :, 1], angles[:, None]),
                   qkv[:, :, 2])
        att = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        x = x + self.wo(att.transpose(1, 2).reshape(b, n, c))
        return x + self.mlp(self.norm1(x))


class VisionTower(nn.Module):
    """Pixels [B, 3, H, W] (H, W multiples of patch * merge) -> merged
    patches [B, (H/28)(W/28), 4 * 1152], row-major over the merged grid,
    each the concatenation of its 2x2 patches in row-major order."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(VisionBlock(cfg) for _ in range(cfg.vit_layers))
        self.encoder.final_layernorm = nn.LayerNorm(cfg.vit_hidden_size, eps=cfg.vit_eps)

    def forward(self, pixels):
        cfg = self.cfg
        x, (h, w) = self.patch_embed(pixels)
        angles = vit_rope_angles(h, w, cfg.vit_hidden_size // cfg.vit_heads, cfg.vit_rope_theta, x.device)
        for blk in self.encoder.blocks:
            x = blk(x, angles)
        x = self.encoder.final_layernorm(x)
        m = cfg.merge
        b, _, c = x.shape
        x = x.view(b, h // m, m, w // m, m, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (h // m) * (w // m), m * m * c)


class Projector(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.patch = cfg.vit_hidden_size
        self.pre_norm = nn.LayerNorm(cfg.vit_hidden_size, eps=cfg.projector_eps)
        self.linear_1 = nn.Linear(cfg.merged_width, cfg.merged_width)
        self.linear_2 = nn.Linear(cfg.merged_width, cfg.hidden_size)

    def forward(self, merged):
        x = self.pre_norm(merged.unflatten(-1, (-1, self.patch))).flatten(-2)
        return self.linear_2(F.gelu(self.linear_1(x)))


# ---------------------------------------------------------------- decoder


@dataclasses.dataclass
class Packed:
    """A ragged batch packed on one token axis: world b's tokens are
    ``starts[b]:starts[b] + lengths[b]``."""

    lengths: torch.Tensor  # [B] int64 on the device
    starts: torch.Tensor  # [B]
    world: torch.Tensor  # [T] the world of each token
    pos: torch.Tensor  # [T] its position in its world
    longest: int

    @classmethod
    def of(cls, lengths: list[int], device) -> "Packed":
        n = torch.tensor(lengths, device=device, dtype=torch.int64)
        starts = torch.cumsum(n, 0) - n
        total = sum(lengths)
        world = torch.repeat_interleave(torch.arange(len(lengths), device=device), n, output_size=total)
        pos = torch.arange(total, device=device) - starts[world]
        return cls(n, starts, world, pos, max(lengths))

    @property
    def last(self) -> torch.Tensor:
        return self.starts + self.lengths - 1


class LatentCache:
    """Per layer, [B, longest + steps, kv_lora_rank + rope] bf16: each
    token's normalised latent and roped key at its position; ``lengths`` is
    each world's filled length."""

    def __init__(self, layers: int, batch: int, slots: int, width: int, lengths: torch.Tensor, dtype, device):
        self.kv = [torch.zeros(batch, slots, width, dtype=dtype, device=device) for _ in range(layers)]
        self.lengths = lengths.clone()
        self.slots = slots


class MLA(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = nn.Linear(h, nh * cfg.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False)
        self.o_proj = nn.Linear(nh * cfg.v_head_dim, h, bias=False)
        self.scale = cfg.qk_head_dim ** -0.5

    def _project(self, x, pos):
        """q [N, nh, 192] (its rope part roped) and the cache entry [N, 576]."""
        cfg = self.cfg
        nope, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        angles = rope_angles(pos, r, cfg.rope_theta)
        q = self.q_proj(x).view(x.shape[0], cfg.num_attention_heads, cfg.qk_head_dim)
        q = torch.cat([q[..., :nope], rope_pairs(q[..., nope:], angles[:, None])], -1)
        kv = self.kv_a_proj_with_mqa(x)
        entry = torch.cat([self.kv_a_layernorm(kv[:, :cfg.kv_lora_rank]),
                           rope_pairs(kv[:, cfg.kv_lora_rank:], angles)], -1)
        return q, entry

    def prefill(self, x, packed: Packed, cache: torch.Tensor):
        cfg = self.cfg
        nh, nope, lat = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
        q, entry = self._project(x, packed.pos)
        cache.view(-1, cache.shape[-1]).index_copy_(0, packed.world * cache.shape[1] + packed.pos, entry)
        kv = self.kv_b_proj(entry[:, :lat]).view(-1, nh, nope + cfg.v_head_dim)
        k = torch.cat([kv[..., :nope], entry[:, None, lat:].expand(-1, nh, -1)], -1)
        b, lp = packed.lengths.shape[0], packed.longest
        slot = packed.world * lp + packed.pos

        def padded(t):
            out = t.new_zeros(b * lp, *t.shape[1:])
            out.index_copy_(0, slot, t)
            return out.view(b, lp, nh, -1).transpose(1, 2)

        att = F.scaled_dot_product_attention(padded(q), padded(k), padded(kv[..., nope:].contiguous()),
                                             is_causal=True, scale=self.scale)
        att = att.transpose(1, 2).reshape(b * lp, nh * cfg.v_head_dim).index_select(0, slot)
        return self.o_proj(att)

    def decode(self, x, pos, cache: torch.Tensor):
        """One token a world at positions ``pos`` [B], absorbed into the latent."""
        cfg = self.cfg
        nh, nope, lat = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
        b = x.shape[0]
        q, entry = self._project(x, pos)
        cache.view(-1, cache.shape[-1]).index_copy_(0, torch.arange(b, device=x.device) * cache.shape[1] + pos,
                                                    entry)
        w = self.kv_b_proj.weight.view(nh, nope + cfg.v_head_dim, lat)
        q_lat = torch.bmm(q[..., :nope].transpose(0, 1), w[:, :nope]).transpose(0, 1)  # [B, nh, lat]
        scores = torch.bmm(torch.cat([q_lat, q[..., nope:]], -1), cache.transpose(1, 2)).float()
        future = torch.arange(cache.shape[1], device=x.device)[None, :] > pos[:, None]
        p = torch.softmax(scores.mul_(self.scale).masked_fill_(future[:, None], float("-inf")), -1)
        o_lat = torch.bmm(p.to(cache.dtype), cache[..., :lat])  # [B, nh, lat]
        o = torch.bmm(o_lat.transpose(0, 1), w[:, nope:].transpose(1, 2)).transpose(0, 1)  # [B, nh, v]
        return self.o_proj(o.reshape(b, nh * cfg.v_head_dim))


class DenseMLP(nn.Module):
    """SwiGLU with gate and up fused: layer 0's MLP and the shared experts."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_up_proj = nn.Linear(hidden, 2 * width, bias=False)
        self.down_proj = nn.Linear(width, hidden, bias=False)

    def forward(self, x):
        g, u = self.gate_up_proj(x).chunk(2, -1)
        return self.down_proj(F.silu(g) * u)


class Router(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(torch.empty(cfg.n_routed_experts, dtype=torch.float32))

    def forward(self, x):
        """(experts [N, k], weights [N, k] float32): the top k by sigmoid
        score plus the correction bias, weighted by their own scores,
        renormalised and scaled."""
        cfg = self.cfg
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        idx = torch.topk(scores + self.e_score_correction_bias, cfg.num_experts_per_tok, -1, sorted=False)[1]
        w = scores.gather(1, idx)
        if cfg.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * cfg.routed_scaling_factor


def balance_routers(model: nn.Module, route, target: float, step: float, passes: int) -> list[float]:
    """Auxiliary-loss-free load balancing of the routers' correction biases
    (DeepSeek-V3, sec. 2.1.2): ``route()`` sends a batch through the model;
    after each pass, in every expert layer whose heaviest expert took more
    than ``target`` times the mean load, each expert's bias moves by
    ``step`` against the sign of its load's excess over the mean. Stops
    when every layer is at or under ``target``, or after ``passes``
    updates. Returns each expert layer's heaviest-over-mean load of the
    last pass."""
    routers = [m for m in model.modules() if isinstance(m, Router)]
    loads = [None] * len(routers)

    def count(i):
        def hook(mod, args, out):
            e = mod.cfg.n_routed_experts
            loads[i] = torch.bincount(out[0].flatten(), minlength=e).float()
        return hook

    hooks = [r.register_forward_hook(count(i)) for i, r in enumerate(routers)]
    try:
        for p in range(passes + 1):
            route()
            ratios = [float(n.max() / n.mean()) for n in loads]
            if p == passes or max(ratios) <= target:
                break
            with torch.no_grad():
                for r, n, ratio in zip(routers, loads, ratios):
                    if ratio > target:
                        r.e_score_correction_bias -= step * torch.sign(n - n.mean())
    finally:
        for h in hooks:
            h.remove()
    return ratios


class Experts(nn.Module):
    """The routed experts' weights stacked: gate and up [E, 2I, H], down [E, H, I]."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        e, h, i = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate_up_proj = nn.Parameter(torch.empty(e, 2 * i, h))
        self.down_proj = nn.Parameter(torch.empty(e, h, i))


def grouped_experts(x, idx, w, gate_up, down):
    """sum_j w[n, j] * expert_{idx[n, j]}(x[n]) for every token n: the
    token-expert pairs sorted by expert, two grouped products over the
    experts' runs (gate and up fused, then down), the weighted results
    scattered back into token order. Returns (out like x, pairs an expert)."""
    k, e = idx.shape[1], gate_up.shape[0]
    flat = idx.flatten()
    order = torch.argsort(flat, stable=True)
    token = order // k
    load = torch.zeros(e, dtype=torch.int64, device=x.device).index_add_(0, flat, torch.ones_like(flat))
    offs = torch.cumsum(load, 0).to(torch.int32)  # no synchronize: bincount would read its size back
    h = torch._grouped_mm(x.index_select(0, token), gate_up.transpose(1, 2), offs=offs)
    g, u = h.chunk(2, -1)
    y = torch._grouped_mm(F.silu(g) * u, down.transpose(1, 2), offs=offs)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    out.index_add_(0, token, y.float() * w.flatten()[order, None])
    return out.to(x.dtype), load


class MoE(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.gate = Router(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = DenseMLP(cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts)

    def forward(self, x):
        with span("label.moe"):
            idx, w = self.gate(x)
            routed, load = grouped_experts(x, idx, w, self.experts.gate_up_proj, self.experts.down_proj)
            tally("moe_pairs", idx.numel())
            tally("moe_max_load", load.max())
            tally("moe_experts_hit", (load > 0).sum())
            return routed + self.shared_experts(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: KimiVLConfig, index: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = (DenseMLP(cfg.hidden_size, cfg.intermediate_size) if index < cfg.first_k_dense_replace
                    else MoE(cfg))

    def forward(self, x, attend):
        x = x + attend(self.self_attn, self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LanguageModel(nn.Module):
    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)


class KimiVL(nn.Module):
    """The whole model. ``encode_images`` runs the tower and projector;
    ``prefill`` a packed ragged batch of prompts into a fresh cache;
    ``decode`` one token a world through it. Both return the logits of each
    world's newest position."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_tower = VisionTower(cfg)
        self.multi_modal_projector = Projector(cfg)
        self.language_model = LanguageModel(cfg)

    @classmethod
    def random(cls, cfg: KimiVLConfig, seed: int, device, router_bias_std: float,
               dtype=torch.bfloat16) -> "KimiVL":
        """Weights drawn on ``device`` from ``seed``: every linear, embedding,
        conv and position table N(0, 0.02^2), biases 0, norms 1, the router's
        correction bias N(0, router_bias_std^2) in float32; the rest in
        ``dtype``."""
        with torch.device("meta"):
            model = cls(cfg).to(dtype)
            for m in model.modules():
                if isinstance(m, Router):
                    m.e_score_correction_bias = nn.Parameter(torch.empty(cfg.n_routed_experts))
        model.to_empty(device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        with torch.no_grad():
            for name, p in sorted(model.named_parameters()):
                if name.endswith("e_score_correction_bias"):
                    p.normal_(0.0, router_bias_std, generator=gen)
                elif name.endswith("bias"):
                    p.zero_()
                elif p.dim() == 1:  # a norm's scale
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, INIT_STD, generator=gen)
        return model.eval().requires_grad_(False)

    def encode_images(self, pixels):
        """[B, 3, H, W] normalised pixels -> [B, image tokens, hidden]."""
        x = pixels.to(self.language_model.embed_tokens.weight.dtype)
        return self.multi_modal_projector(self.vision_tower(x))

    def _logits(self, x):
        lm = self.language_model
        return lm.lm_head(lm.norm(x))

    def prefill(self, ids, lengths: list[int], image, image_at: int, steps: int):
        """Packed prompt ids [T] of worlds of ``lengths``, each with its image
        tokens [B, n, hidden] in place of ids ``image_at:image_at + n``.
        Returns (logits [B, vocab] of each prompt's last position, a cache
        with room for ``steps`` more tokens a world)."""
        lm, cfg = self.language_model, self.cfg
        packed = Packed.of(lengths, ids.device)
        tally("label_prefill_tokens", ids.shape[0])
        x = lm.embed_tokens(ids)
        n = image.shape[1]
        slots = (packed.starts[:, None] + image_at + torch.arange(n, device=ids.device)).flatten()
        x = x.index_copy(0, slots, image.flatten(0, 1).to(x.dtype))
        cache = LatentCache(len(lm.layers), len(lengths), packed.longest + steps,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim, packed.lengths, x.dtype, x.device)
        for layer, kv in zip(lm.layers, cache.kv):
            x = layer(x, lambda attn, y, kv=kv: attn.prefill(y, packed, kv))
        return self._logits(x.index_select(0, packed.last)), cache

    def decode(self, ids, cache: LatentCache):
        """The next id of every world [B] -> logits [B, vocab] at its
        position; the cache grows by one token a world."""
        lm = self.language_model
        pos = cache.lengths
        x = lm.embed_tokens(ids)
        for layer, kv in zip(lm.layers, cache.kv):
            x = layer(x, lambda attn, y, kv=kv: attn.decode(y, pos, kv))
        cache.lengths = pos + 1
        return self._logits(x)


def parameter_count(cfg: KimiVLConfig) -> dict:
    """{"vision": tower and projector, "decoder": the rest, "active": what
    one decoder token reads (all but the unchosen routed experts and the
    unused rows of the embedding)}, counted on the meta device."""
    with torch.device("meta"):
        model = KimiVL(cfg)
    vis = sum(p.numel() for n, p in model.named_parameters() if not n.startswith("language_model"))
    dec = sum(p.numel() for n, p in model.named_parameters() if n.startswith("language_model"))
    moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    expert = 3 * cfg.hidden_size * cfg.moe_intermediate_size
    idle = moe_layers * expert * (cfg.n_routed_experts - cfg.num_experts_per_tok)
    active = dec - idle - (cfg.vocab_size - 1) * cfg.hidden_size
    return {"vision": vis, "decoder": dec, "active": active}
