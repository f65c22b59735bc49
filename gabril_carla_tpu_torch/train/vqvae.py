"""VQ-VAE pretraining: encoder + straight-through quantizer + decoder (port
of gabril_carla_tpu/train/vqvae.py).

The reference's Oreo dropout needs a frozen pretrained quantizer
(train/train_bc.py:87-99 loads the encoder and quantizer weights of a VQ-VAE
checkpoint; model at models/linear_models.py:285-299). This trainer makes
that checkpoint: reconstruction MSE plus the mean per-sample VQ loss, in the
same Trainer loop (train/loop.py, mode "vqvae").

Parameters are the flat state dict of ``VQVAE`` ("encoder.*",
"quantizer.codebook", "decoder.*"), so BC's Oreo adopts the "encoder." and
"quantizer." entries as they are. NCHW throughout.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from ..convert import flax_init, orthogonal_init, vqvae_layout, vqvae_params_from_flax
from ..models.encoder import Decoder, Encoder
from ..models.vq import VectorQuantizer
from ..ops.image import format_obs_stack, stack_window_indices
from ..parallel.mesh import pmean
from ..utils.prng import fold_in, normal, randint, split
from .bc import _dtype, full_f32
from .optim import TrainState


class VQVAE(nn.Module):
    """Encoder -> quantizer -> decoder over the frame stack; ``forward``
    returns (reconstruction in the compute dtype, the quantizer's output)."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg.model
        dt = _dtype(cfg)
        cin = cfg.data["frame_stack"] * (1 if m["grayscale"] else 3)
        self.encoder = Encoder(cin, m["embedding_dim"], m["num_hiddens"], m["num_residual_layers"],
                               m["num_residual_hiddens"], dt)
        self.quantizer = VectorQuantizer(m["embedding_dim"], cfg.get_path("dropout.num_embeddings", 512),
                                         0.25)
        self.decoder = Decoder(m["embedding_dim"], cin, m["num_hiddens"], m["num_residual_layers"],
                               m["num_residual_hiddens"], dt)

    def forward(self, x):
        out = self.quantizer(self.encoder(x))
        return self.decoder(out.quantized), out


def build_vqvae_models(cfg, device="cuda") -> VQVAE:
    full_f32()
    return VQVAE(cfg).to(device)


VQVAE_ROOTS = ("encoder", "quantizer", "decoder")  # split(key, 3), JAX vqvae.py:40


def init_vqvae_params(model: VQVAE, cfg, key) -> dict:
    """The JAX package's init from ``key`` (vqvae.py:36-45): ``split(key,
    3)`` keys the encoder's, the quantizer's and the decoder's own
    ``init``; kernels orthogonal with relu gain from their flax paths'
    keys (convert.flax_init), zero biases, the raw codebook U(0, 2/K).
    Drawn on the host, copied into ``model`` in place. Returns the state
    dict."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tree = flax_init(vqvae_layout(cfg), shapes, dict(zip(VQVAE_ROOTS, split(key, 3))), orthogonal_init)
    model.load_state_dict(vqvae_params_from_flax(tree, cfg))
    return model.state_dict()


def init_vqvae_state(cfg, key, tx, device="cuda"):
    """(model on ``device``, TrainState with a copy of the params from
    ``key``)."""
    model = build_vqvae_models(cfg, device)
    params = {k: v.detach().clone() for k, v in init_vqvae_params(model, cfg, key).items()}
    return model, TrainState.create(params, tx)


def stacked_frames(cfg, obs_seq: torch.Tensor) -> torch.Tensor:
    """The last frame stack of ``obs_seq`` [B, L, H, W, C] as NCHW float32."""
    idxs = stack_window_indices(obs_seq.shape[1] - 1, cfg.data["frame_stack"], obs_seq.shape[1])
    return format_obs_stack(obs_seq[:, torch.from_numpy(idxs).long().to(obs_seq.device)],
                            grayscale=cfg.model["grayscale"])


def vqvae_loss_fn(params: dict, model: VQVAE, cfg, batch):
    """Reconstruction MSE + mean per-sample VQ loss -> (total, metrics)."""
    x = stacked_frames(cfg, batch["obs_seq"])
    recon, out = functional_call(model, params, (x,))
    recon_loss = torch.mean((recon.float() - x) ** 2)
    vq_loss = torch.mean(out.loss)
    total = recon_loss + vq_loss
    return total, {"loss": total, "loss_recon": recon_loss, "loss_vq": vq_loss,
                   "perplexity": out.perplexity}


def vqvae_loss_and_grads(model: VQVAE, cfg, params: dict, batch):
    """(loss, metrics, grads) of vqvae_loss_fn; grads a dict like ``params``."""
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, metrics = vqvae_loss_fn(live, model, cfg, batch)
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_vqvae_train_step(model: VQVAE, cfg, group=None):
    """(state, batch, rng) -> (new state, metrics). The step draws nothing;
    ``rng`` is accepted for the epoch loop's sake and ignored. With a
    process ``group``, gradients and metrics are averaged over it before
    the optimizer (JAX vqvae.py:70-72)."""

    def step(state: TrainState, batch, rng=None):
        _, metrics, grads = vqvae_loss_and_grads(model, cfg, state.params, batch)
        if group is not None:
            grads, metrics = pmean((grads, metrics), group)
        return state.apply_gradients(grads), metrics

    return step


def revive_draws(key, n_rows: int, num_embeddings: int, dim: int, device) -> dict:
    """The draws of one revive from the threefry ``key`` (JAX
    vqvae.py:109-110), on the host, then on ``device``: ``pick`` [K] latent
    rows, ``randint(key, (K,), 0, n_rows)``, and ``jitter`` [K, D] standard
    normals from ``fold_in(key, 1)`` (scaled by 0.01 in the revive)."""
    return {"pick": torch.from_numpy(randint(key, (num_embeddings,), 0, n_rows)).to(device),
            "jitter": torch.from_numpy(normal(fold_in(key, 1), (num_embeddings, dim))).to(device)}


def make_revive_dead_codes(model: VQVAE, cfg):
    """Dead-codebook revival, run between epochs by the Trainer.

    Straight-through VQ training can collapse: every latent maps to one
    code, the rest of the codebook gets no gradient and drifts away. Codes
    no latent of the probe batch maps to are re-seeded with randomly picked
    batch latents plus a small jitter (and the +1/K the quantizer's
    recentring removes). ``revive(params, batch, rng) -> (params, dead
    count)``; ``rng`` is a threefry key or the draws of revive_draws.
    """
    enc_prefix = "encoder."

    @torch.no_grad()
    def revive(params: dict, batch, rng):
        x = stacked_frames(cfg, batch["obs_seq"])
        enc = {k[len(enc_prefix):]: v for k, v in params.items() if k.startswith(enc_prefix)}
        z = functional_call(model.encoder, enc, (x,)).float()
        flat = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1])  # rows (b, y, x), as NHWC
        raw = params["quantizer.codebook"]
        k = raw.shape[0]
        codebook = raw - 1.0 / k  # the quantizer recentres at apply time
        dist = (torch.sum(flat**2, 1, keepdim=True) + torch.sum(codebook**2, 1)[None]
                - 2.0 * flat @ codebook.T)
        used = torch.zeros(k, dtype=torch.bool, device=raw.device)
        used[torch.argmin(dist, dim=1)] = True
        draws = rng if isinstance(rng, dict) else revive_draws(rng, flat.shape[0], k, flat.shape[1],
                                                                raw.device)
        if tuple(draws["pick"].shape) != (k,) or tuple(draws["jitter"].shape) != (k, flat.shape[1]):
            raise ValueError(f"revive draws must be pick [{k}] and jitter [{k}, {flat.shape[1]}]")
        fresh = flat[draws["pick"].long()] + 0.01 * draws["jitter"] + 1.0 / k
        out = dict(params)
        out["quantizer.codebook"] = torch.where(used[:, None], raw, fresh).to(raw.dtype)
        return out, torch.sum(~used)

    return revive
