"""Straight-through vector quantizer (port of gabril_carla_tpu/models/vq.py).
Parity: linear_models.py:19-75.

The ``codebook`` parameter is flax's raw one, U(0, 2/K) at init, recentred
by -1/K in the forward as flax does, so the same tensor carries across
(convert.params_from_flax). Rows of the flattened latent are (b, y, x), as
the JAX package's NHWC flatten, so the indices agree.

Trainable (the VQ-VAE, train/vqvae.py): the codebook takes its gradient
through the per-sample q loss, the latent through the commitment term and
the straight-through estimator ``z + (q - z).detach()``. The distances are
a float32 matmul outside autograd (only their argmin is used); TF32 is off
(train/bc.py: full_f32), as JAX's precision="highest" there. Oreo calls it
frozen, under no_grad (train/bc.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class VQOutput:
    quantized: torch.Tensor  # [B, D, h, w], straight-through
    loss: torch.Tensor  # [B] per-sample q + cc*e loss
    perplexity: torch.Tensor  # scalar
    encoding_indices: torch.Tensor  # [B, h*w] int64


class VectorQuantizer(nn.Module):
    def __init__(self, embedding_dim: int, num_embeddings: int, commitment_cost: float = 0.25):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.commitment_cost = commitment_cost
        self.codebook = nn.Parameter(torch.empty(num_embeddings, embedding_dim))

    def forward(self, z: torch.Tensor) -> VQOutput:
        b, d, h, w = z.shape
        codebook = self.codebook - 1.0 / self.num_embeddings
        zf = z.float()
        with torch.no_grad():
            flat = zf.permute(0, 2, 3, 1).reshape(-1, d)
            dist = (torch.sum(flat**2, dim=1, keepdim=True) + torch.sum(codebook**2, dim=1)[None, :]
                    - 2.0 * flat @ codebook.T)
            idx = torch.argmin(dist, dim=1)  # [B*h*w]
        # an embedding lookup: its backward sums each code's rows in one
        # segmented pass (indexing's backward took 15 ms of a 53 ms VQ-VAE
        # step at batch 256 on the card)
        quantized = F.embedding(idx, codebook).reshape(b, h, w, d).permute(0, 3, 1, 2)

        e_loss = torch.mean((quantized.detach() - zf) ** 2, dim=(1, 2, 3))
        q_loss = torch.mean((quantized - zf.detach()) ** 2, dim=(1, 2, 3))
        loss = q_loss + self.commitment_cost * e_loss

        quantized_st = zf + (quantized - zf).detach()
        avg_probs = torch.bincount(idx, minlength=self.num_embeddings).float() / idx.numel()
        perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        return VQOutput(quantized=quantized_st, loss=loss, perplexity=perplexity,
                        encoding_indices=idx.reshape(b, h * w))
