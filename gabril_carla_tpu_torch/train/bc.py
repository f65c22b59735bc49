"""Behavior cloning: models, loss, train step and eval policy for the 8 gaze
methods x 4 dropout methods (port of gabril_carla_tpu/train/bc.py).

Numeric contract: vlm_gaze/train/train_bc.py:203-299 (method dispatch, ivg
partial-gaze selection, mask composition, loss composition) and
train_bc.py:133-194 (regularization losses). Per-sample gaze participation
(ivg) is a weight, as in the JAX package, not a boolean index.

NCHW throughout: frames are [B, S*C', H, W], heat [B, S, H, W], latents
[B, D, h, w]. Parameters are a flat dict ``{"encoder.down1.weight": ...}``
(``BCModels``' state dict), applied with ``torch.func.functional_call``.

Randomness. A train step takes ``rng``: a threefry key (utils/prng.py,
two uint32 words), from which it draws what the JAX package's step draws
from the same key (bc.py:222: ``split(key, 4)`` gives the GMD, IGMD and
Oreo keys), or the draws themselves as a dict:
  * ``"igmd"``: two uniform tensors [B, 1, H/2, W/2] and [B, 1, H/4, W/4],
    from the encoder's two ``make_rng("dropout")`` keys of the IGMD key;
  * ``"gmd"``: uniforms [B, 1, h, w] on the latent grid;
  * ``"oreo"``: the code mask [m*B, num_embeddings] of 0/1 floats, a
    Bernoulli of 1 - oreo_prob.
A key's draws run on the batch's device (ops/threefry_kernel.py: the
kernel on the card). NCHW [B, 1, h, w] and JAX's NHWC [B, h, w, 1] share one
flat order, so the draws are JAX's element for element. All of them are
drawn before the forward, so a rematerialized encoder replays the same
masks.

Oreo with a regularizer (Teacher, Reg, Contrastive, GRIL) and
``oreo_num_mask`` m > 1: the JAX package fails there on a shape mismatch
(its regularizer sees B targets and m*B latents). Here every per-sample
target of the regularizer is tiled m-major, as the actions are; with m = 1
this is the JAX package's loss.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..convert import bc_layout, flax_init, orthogonal_init, params_from_flax
from ..models.encoder import Encoder, igmd_hw, latent_hw
from ..models.heads import MLP, Actor, PreActor
from ..models.vq import VectorQuantizer
from ..ops import threefry_kernel
from ..ops.gaze import gaze_mask_from_latent, gmd_dropout
from ..ops.heatmap import GazeHeatmapper
from ..parallel.mesh import pmean
from ..utils.prng import flax_fold, split
from ..utils.profiling import span
from .optim import TrainState, masked

GAZE_METHODS = ("None", "Teacher", "Reg", "Mask", "Contrastive", "ViSaRL", "AGIL", "GRIL")
DROPOUT_METHODS = ("None", "GMD", "IGMD", "Oreo")


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.get_path("training.compute_dtype", "float32") == "bfloat16" else torch.float32


def full_f32():
    """Float32 convolutions and matmuls run in full float32 on the card, as
    the JAX package's precision="highest" contracts (resize, splat, VQ
    distances) and its float32 models do: cuDNN takes TF32 by default. The
    flags are the process's; bf16 convolutions do not read them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def encoder_input_channels(cfg) -> int:
    """coeff * S * (1|3), coeff=2 for ViSaRL (train_bc.py:60-61)."""
    coeff = 2 if cfg.gaze["method"] == "ViSaRL" else 1
    per = 1 if cfg.model["grayscale"] else 3
    return coeff * cfg.data["frame_stack"] * per


class BCModels(nn.Module):
    """encoder, pre_actor, actor, and per method encoder_agil (AGIL),
    gril_head (GRIL) and quantizer (Oreo); ``forward`` is the eval policy.
    ``heatmapper`` and ``cfg`` ride along as plain attributes."""

    def __init__(self, cfg):
        super().__init__()
        m, g, d = cfg.model, cfg.gaze, cfg.dropout
        if g["method"] not in GAZE_METHODS or d["method"] not in DROPOUT_METHODS:
            raise ValueError(f"unknown gaze method {g['method']!r} or dropout {d['method']!r}")
        dt = _dtype(cfg)
        lh, lw = latent_hw(cfg.data["img_height"], cfg.data["img_width"])
        per = 1 if m["grayscale"] else 3

        def mk_enc(cin):
            return Encoder(cin, m["embedding_dim"], m["num_hiddens"], m["num_residual_layers"],
                           m["num_residual_hiddens"], dt)

        self.encoder = mk_enc(encoder_input_channels(cfg))
        self.pre_actor = PreActor(m["embedding_dim"] * lh * lw, m["z_dim"], dt)
        self.actor = Actor(cfg.data["action_dim"], m["z_dim"], dt)
        self.encoder_agil = mk_enc(cfg.data["frame_stack"] * per) if g["method"] == "AGIL" else None
        # GRIL's coordinate head: Linear-ReLU-Linear(max_points*2) (train_bc.py:73-76)
        self.gril_head = (MLP(m["z_dim"], g["max_points"] * 2, m["z_dim"], hidden_depth=1, dtype=dt)
                          if g["method"] == "GRIL" else None)
        self.quantizer = (VectorQuantizer(m["embedding_dim"], d["num_embeddings"], 0.25)
                          if d["method"] == "Oreo" else None)
        self.heatmapper = GazeHeatmapper(
            img_height=cfg.data["img_height"],
            img_width=cfg.data["img_width"],
            gaze_sigma=g["mask_sigma"],
            gaze_coeff=g["mask_coeff"],
            maxpoints=g["max_points"],
            temporal_alpha=g.get("temporal_alpha", 0.7),
            temporal_mode=g.get("temporal_mode", "alpha_decay"),
            temporal_sigmas=g.get("temporal_sigmas"),
            temporal_coeffs=g.get("temporal_coeffs"),
            temporal_offset_start=g.get("temporal_offset_start", 0),
        )
        self.cfg = cfg

    def forward(self, obs, heat=None):
        """Eval policy (BCAgent._predict_control, bc_agent.py:271-305): obs
        [B, S*C', H, W], heat [B, S, H, W] or None (zeros) -> float32 [B, A]."""
        g, d = self.cfg.gaze, self.cfg.dropout
        method = g["method"]
        if heat is None:
            b, _, h, w = obs.shape
            heat = obs.new_zeros((b, self.cfg.data["frame_stack"], h, w), dtype=torch.float32)
        if method == "Mask":
            enc_in = obs * heat
        elif method == "ViSaRL":
            enc_in = torch.cat([obs, heat], 1)
        else:
            enc_in = obs
        kwargs = dict(dropout_mask=heat, deterministic=True) if d["method"] == "IGMD" else {}
        z = self.encoder(enc_in, **kwargs)
        if method == "AGIL":
            z = 0.5 * (z + self.encoder_agil(obs * heat))
        if d["method"] == "GMD":
            z = gmd_dropout(z, heat, test_mode=True)
        return self.actor(self.pre_actor(z)).float()


def build_bc_models(cfg, device="cuda") -> BCModels:
    """The modules for ``cfg``, their (float32) parameters on ``device``.
    Every entry point starts here, so this is where TF32 is turned off
    (full_f32)."""
    full_f32()
    return BCModels(cfg).to(device)


BC_ROOTS = ("encoder", "pre_actor", "actor", "encoder_agil", "gril_head", "quantizer")  # split(key, 6)


def init_bc_params(models: BCModels, cfg, key) -> dict:
    """The JAX package's init from the threefry ``key`` (bc.py:96-113):
    ``split(key, 6)`` keys the submodules' own ``init`` calls, and each
    kernel is drawn from its flax path's key (convert.flax_init):
    orthogonal with relu gain for convs, gain 1 for dense layers, zero
    biases, Oreo's raw codebook U(0, 2/K). Drawn on the host, copied into
    ``models`` in place. Returns the state dict."""
    shapes = {k: tuple(v.shape) for k, v in models.state_dict().items()}
    tree = flax_init(bc_layout(cfg), shapes, dict(zip(BC_ROOTS, split(key, len(BC_ROOTS)))),
                     orthogonal_init)
    models.load_state_dict(params_from_flax(tree, cfg))
    return models.state_dict()


def init_bc_state(cfg, key, tx, device="cuda") -> tuple[BCModels, TrainState]:
    """Models on ``device`` and a TrainState holding a copy of their
    parameters from ``key``. Oreo's quantizer is frozen (the reference sets
    requires_grad=False, train_bc.py:91-93) and masked out of the
    optimizer, so weight decay cannot move it."""
    models = build_bc_models(cfg, device)
    params = {k: v.detach().clone() for k, v in init_bc_params(models, cfg, key).items()}
    if models.quantizer is not None:
        tx = masked(tx, ("quantizer.",))
    return models, TrainState.create(params, tx)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _apply(models: BCModels, params: dict, name: str, *args, **kwargs):
    """``models.<name>`` applied with its entries of the flat ``params``."""
    pre = name + "."
    sub = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
    return functional_call(getattr(models, name), sub, args, kwargs)


def _weighted_mean(per_sample: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean over selected samples; 0 if none selected."""
    tot = torch.sum(w)
    return torch.where(tot > 0, torch.sum(per_sample * w) / tot.clamp_min(1e-8),
                       torch.zeros((), device=w.device))


def _kl(a, b):
    return torch.sum(a * torch.log((a + 1e-6) / (b + 1e-6)), dim=(1, 2, 3))


def gaze_hash(per_key: torch.Tensor) -> torch.Tensor:
    """Per-sample pseudo-random number in [0, 1) from a content key: the
    Knuth multiplicative hash of the key's float32 bit pattern (int32
    product, wrapping), low 15 bits (bc.py:246-255). The low 15 bits of the
    int64 product are those of the wrapped int32 one."""
    kbits = per_key.float().contiguous().view(torch.int32).long()
    return ((kbits * -1640531527) & 32767).float() / 32768.0


def _reg_loss(models: BCModels, cfg, params, z, z_flat, gg, gc, xx, ivg, rep: int = 1):
    """Gaze regularization (train_bc.py:133-194). gg is [B, S, H, W]; z and
    z_flat carry Oreo's ``rep`` m-major copies of the batch, the targets are
    tiled to match."""
    g = cfg.gaze
    method = g["method"]
    b = xx.shape[0]
    ivg = ivg.repeat(rep)

    if method in ("Teacher", "Reg"):
        g1 = gg[:, -1:].float().detach().repeat(rep, 1, 1, 1)  # [B', 1, H, W]
        g2 = gaze_mask_from_latent(z.float(), g["beta"], (xx.shape[2], xx.shape[3]))[:, None]
        kind = g["prob_dist_type"]
        if kind in ("TV", "JS", "KL"):
            g1 = g1 / (torch.sum(g1, dim=(1, 2, 3), keepdim=True) + 1e-8).detach()
            g2 = g2 / (torch.sum(g2, dim=(1, 2, 3), keepdim=True) + 1e-8).detach()
        if kind == "KL":
            return _weighted_mean(_kl(g1, g2), ivg)
        if kind == "TV":
            return _weighted_mean(torch.sum(torch.abs(g1 - g2), dim=(1, 2, 3)), ivg)
        if kind == "JS":
            mid = (g1 + g2) / 2
            return 0.5 * (_weighted_mean(_kl(g1, mid), ivg) + _weighted_mean(_kl(g2, mid), ivg))
        if kind == "MSE":
            return _weighted_mean(torch.mean((g1 - g2) ** 2, dim=(1, 2, 3)), ivg)
        raise ValueError(f"Invalid prob_dist_type: {kind}")

    if method == "Contrastive":
        # gaze-masked vs inverse-masked observations (the JAX package's
        # analytic pair; its branch for dataset-packed pos/neg stacks is
        # unreachable from prepare_for_bc's S-channel heat and is not ported)
        z_plus = _apply(models, params, "encoder", xx * gg).float().repeat(rep, 1, 1, 1)
        z_minus = _apply(models, params, "encoder", xx * (1.0 - gg)).float().repeat(rep, 1, 1, 1)
        zf32 = z.float()
        t1 = torch.sum((zf32 - z_plus) ** 2, dim=(1, 2, 3))
        t2 = torch.sum((zf32 - z_minus) ** 2, dim=(1, 2, 3))
        margin = torch.maximum(t1.new_zeros(()), t1 - t2 + g["contrastive_threshold"])
        # a sample whose gaze stack has no mass gives neg == xx, an
        # unsatisfiable hinge: gate it out (bc.py:183-196)
        has_gaze = (torch.sum(gg, dim=(1, 2, 3)) > 1e-6).float().repeat(rep)
        return _weighted_mean(margin, ivg * has_gaze)

    if method == "GRIL":
        # coordinate MSE over valid points only (bc.py:198-210)
        pred = _apply(models, params, "gril_head", z_flat).float()
        target = gc.reshape(b, -1).float().repeat(rep, 1)
        valid = (target >= 0.0).float()
        se = torch.square(pred - target) * valid
        per = torch.sum(se, dim=-1) / torch.clamp_min(torch.sum(valid, dim=-1), 1.0)
        return _weighted_mean(per, ivg)

    return torch.zeros((), device=xx.device)


def step_draws(rng, cfg, bsz: int, device, train: bool = True, rows=None) -> dict:
    """The random draws of one loss evaluation on a batch of ``bsz``
    (module docstring): from a key, or checked out of a given dict.
    ``rows = (start, total)`` draws this batch as rows [start, start +
    bsz) of a batch of ``total``, JAX's draws for a rank's rows of a
    global batch."""
    d = cfg.dropout["method"]
    h, w = cfg.data["img_height"], cfg.data["img_width"]
    want = {}
    if d == "IGMD" and train:
        want["igmd"] = [(bsz, 1, *hw) for hw in igmd_hw(h, w)]
    if d == "GMD" and train:
        want["gmd"] = (bsz, 1, *latent_hw(h, w))
    if d == "Oreo":
        want["oreo"] = (cfg.dropout["oreo_num_mask"] * bsz, cfg.dropout["num_embeddings"])
    if not want:
        return {}
    if rng is None:
        raise ValueError(f"dropout {d!r} needs a threefry key or explicit draws")
    if isinstance(rng, dict):
        for k, shape in want.items():
            got = [tuple(t.shape) for t in rng[k]] if k == "igmd" else tuple(rng[k].shape)
            if got != shape:
                raise ValueError(f"draws[{k!r}] must be {shape}, got {got}")
        return {k: rng[k] for k in want}
    start, total = (0, bsz) if rows is None else rows
    _, k_gmd, k_igmd, k_oreo = split(rng, 4)

    def rows_of(key, shape, p=None, reps: int = 1):
        # the rows [start, start + bsz) of each of ``reps`` stacked draws of
        # ``total`` rows: contiguous counter ranges of the global draw, one
        # range (one launch) for the whole batch
        per = int(np.prod(shape[1:]))
        if total == bsz:
            return threefry_kernel.random_floats(key, shape[0] * per, device, 0, p).reshape(shape)
        parts = [threefry_kernel.random_floats(key, bsz * per, device, (j * total + start) * per, p)
                 for j in range(reps)]
        return torch.cat(parts).reshape(shape)

    out = {}
    if "igmd" in want:  # the encoder's two make_rng("dropout") keys (models/encoder.py:81, :86)
        out["igmd"] = [rows_of(flax_fold(k_igmd, i + 1), s) for i, s in enumerate(want["igmd"])]
    if "gmd" in want:
        out["gmd"] = rows_of(k_gmd, want["gmd"])
    if "oreo" in want:
        out["oreo"] = rows_of(k_oreo, want["oreo"], 1.0 - cfg.dropout["oreo_prob"],
                              cfg.dropout["oreo_num_mask"])
    return out


def bc_loss_fn(params, models: BCModels, cfg, batch, rng=None, train: bool = True,
               per_key: torch.Tensor | None = None):
    """Full BC loss (train_bc.py:203-299) -> (total, metrics).

    batch: obs_seq [B, L, H, W, C] uint8, gaze_seq [B, L, P*2] float32,
    actions [B, A] or [B, L, A] float32. ``rng``: a key or the draws
    (module docstring). ``per_key`` [B] replaces the content keys of the
    partial-gaze hash (the frame sums), whose float32 summation order
    differs between frameworks.
    """
    g, d = cfg.gaze, cfg.dropout
    with span("train.heat_prep"):
        xx, gg, center = models.heatmapper.prepare_for_bc(
            batch["obs_seq"], batch["gaze_seq"], frame_stack=cfg.data["frame_stack"],
            grayscale=cfg.model["grayscale"], aggregate_stack=bool(g.get("temporal_flag", True)))
    actions = batch["actions"]
    if actions.dim() == 3:
        actions = actions[:, min(center, actions.shape[1] - 1)]
    actions = actions.float()
    bsz = xx.shape[0]
    gc = batch["gaze_seq"][:, center]
    draws = step_draws(rng, cfg, bsz, xx.device, train)

    # partial-gaze selection: content-hash pseudo-random per sample
    # (train_bc.py:229-240)
    ratio = float(g.get("ratio", 1.0))
    if ratio >= 1.0:
        ivg = torch.ones(bsz, device=xx.device)
    elif ratio <= 0.0:
        ivg = torch.zeros(bsz, device=xx.device)
    else:
        if per_key is None:
            per_key = torch.sum(xx.float(), dim=(1, 2, 3))
        ivg = (gaze_hash(per_key) < ratio).float()

    ivg_e = ivg[:, None, None, None]
    gg_mul = ivg_e * gg + (1.0 - ivg_e)  # unused gaze -> identity mask
    gg_cat = ivg_e * gg  # unused gaze -> zero mask

    method = g["method"]
    if method == "Mask":
        enc_in = xx * gg_mul
    elif method == "ViSaRL":
        enc_in = torch.cat([xx, gg_cat], 1)
    else:
        enc_in = xx

    enc_kwargs = {}
    if d["method"] == "IGMD":
        enc_kwargs = dict(dropout_mask=gg_cat, deterministic=not train, uniforms=draws.get("igmd"))
    if cfg.get_path("training.remat", False):
        # rematerialize the encoder's activations in the backward: ~30% more
        # FLOPs for the dominant activation memory at large batch
        z = checkpoint(lambda x: _apply(models, params, "encoder", x, **enc_kwargs), enc_in,
                       use_reentrant=False)
    else:
        z = _apply(models, params, "encoder", enc_in, **enc_kwargs)

    if method == "AGIL":
        z_agil = _apply(models, params, "encoder_agil", xx * gg_mul)
        z = torch.where(ivg_e > 0, 0.5 * (z + z_agil), z)

    rep = 1
    if d["method"] == "GMD":
        z = gmd_dropout(z, gg_cat, test_mode=not train, uniforms=draws.get("gmd"))
    elif d["method"] == "Oreo":
        rep, prob = d["oreo_num_mask"], d["oreo_prob"]
        with torch.no_grad():  # frozen quantizer, indices carry no gradient
            idx = _apply(models, params, "quantizer", z).encoding_indices  # [B, h*w]
        zh, zw = z.shape[2], z.shape[3]
        # m-major tile, matching repeat('b ... -> (m b) ...')
        mask = torch.gather(draws["oreo"], 1, idx.repeat(rep, 1)).reshape(rep * bsz, 1, zh, zw)
        z = z.repeat(rep, 1, 1, 1) * mask / (1.0 - prob)
        actions = actions.repeat(rep, 1)

    z_flat = _apply(models, params, "pre_actor", z)
    logits = _apply(models, params, "actor", z_flat).float()
    actor_loss = torch.mean((logits - actions) ** 2)

    reg_z = z_flat if method == "GRIL" else z
    reg_loss = _reg_loss(models, cfg, params, reg_z, z_flat, gg, gc, xx, ivg, rep)

    total = g["lambda_weight"] * reg_loss + actor_loss
    return total, {"loss": total, "loss_actor": actor_loss, "loss_reg": reg_loss}


def loss_and_grads(models: BCModels, cfg, params: dict, batch, rng=None, train: bool = True,
                   per_key=None):
    """(loss, metrics, grads) of bc_loss_fn; grads a dict like ``params``
    (zeros for a parameter the loss does not reach, as jax.grad gives)."""
    with span("train.forward"):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, metrics = bc_loss_fn(live, models, cfg, batch, rng, train, per_key)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if gr is None else gr for (k, p), gr in zip(live.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_bc_train_step(models: BCModels, cfg, group=None, global_rows: bool = False):
    """(state, batch, rng) -> (new state, metrics): autograd of bc_loss_fn,
    then the optimizer the state carries. ``rng`` is a threefry key or the
    step's draws (module docstring). The state passed in is left as it
    was. With a process ``group`` the gradients and metrics are averaged
    over it in one all-reduce before the optimizer (parallel/mesh.py pmean;
    JAX bc.py:327-329), so every rank applies the same update.
    ``global_rows``: the batch is this rank's rows of a global batch cut by
    parallel/mesh.py shard_batch, and a key draws those rows of the global
    batch's draws, as JAX's step over the sharded batch does; otherwise
    (a rank's own epoch key, device_data.make_sharded_epoch_fn) the key
    draws for the batch as it is."""

    def step(state: TrainState, batch, rng=None):
        with span("train.step"):
            bsz = batch["obs_seq"].shape[0]
            rows = None
            if global_rows and group is not None:
                rows = (dist.get_rank(group) * bsz, dist.get_world_size(group) * bsz)
            with span("train.draws"):
                draws = step_draws(rng, cfg, bsz, batch["obs_seq"].device, rows=rows)
            _, metrics, grads = loss_and_grads(models, cfg, state.params, batch, draws)
            if group is not None:
                with span("train.allreduce"):
                    grads, metrics = pmean((grads, metrics), group)
            with span("train.optimizer"):
                return state.apply_gradients(grads), metrics

    return step


def make_bc_policy_fn(models: BCModels, cfg):
    """Eval-time policy: (params, obs [B, H, W, S*C'], heat [B, H, W, S] or
    None) -> float32 [B, A]. Mirrors BCAgent._predict_control's per-method
    input assembly and GMD/IGMD test mode (bc_agent.py:271-305).

    ``params`` is a state dict of ``models``, with the frozen gaze
    predictor's state dict beside it under "gaze_predictor" at eval (the
    policy leaves it out); obs and heat keep the JAX package's NHWC layout
    (channels-last views feed the convs).
    """

    def policy(params, obs, heat=None):
        if "gaze_predictor" in params:
            params = {k: v for k, v in params.items() if k != "gaze_predictor"}
        heat = None if heat is None else heat.permute(0, 3, 1, 2)
        return functional_call(models, params, (obs.permute(0, 3, 1, 2), heat))

    return policy
