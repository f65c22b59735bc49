"""Straight-through vector quantizer (port of gabril_carla_tpu/models/vq.py,
forward only: Oreo keeps it frozen). Parity: linear_models.py:19-75.

The ``codebook`` parameter is flax's raw one, U(0, 2/K) at init, recentred
by -1/K in the forward as flax does, so the same tensor carries across
(convert.params_from_flax). Rows of the flattened latent are (b, y, x), as
the JAX package's NHWC flatten, so the indices agree.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
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
        flat = zf.permute(0, 2, 3, 1).reshape(-1, d)
        dist = (torch.sum(flat**2, dim=1, keepdim=True) + torch.sum(codebook**2, dim=1)[None, :]
                - 2.0 * flat @ codebook.T)
        idx = torch.argmin(dist, dim=1)  # [B*h*w]
        quantized = codebook[idx].reshape(b, h, w, d).permute(0, 3, 1, 2)

        e_loss = torch.mean((quantized.detach() - zf) ** 2, dim=(1, 2, 3))
        q_loss = torch.mean((quantized - zf.detach()) ** 2, dim=(1, 2, 3))
        loss = q_loss + self.commitment_cost * e_loss

        quantized_st = zf + (quantized - zf).detach()
        avg_probs = torch.bincount(idx, minlength=self.num_embeddings).float() / idx.numel()
        perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        return VQOutput(quantized=quantized_st, loss=loss, perplexity=perplexity,
                        encoding_indices=idx.reshape(b, h * w))
