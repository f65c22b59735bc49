"""MLP heads (port of gabril_carla_tpu/models/heads.py, the policy's part).

Parity: linear_models.py:302-353 and the heads train/train_bc.py:79-86
builds (pre_actor = Flatten + Linear(z_dim); actor = Linear-ReLU-Linear).
Parameters stay float32; each Linear runs in the module's ``dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MLP(nn.Module):
    def __init__(self, in_dim: int, output_dim: int, hidden_dim: int | None = None,
                 hidden_depth: int = 0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = [in_dim] + [hidden_dim] * hidden_depth + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = dense(x, layer, self.dtype)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class PreActor(nn.Module):
    """Flatten + Linear to z_dim (train_bc.py:79).

    The port flattens the NCHW feature map; flax flattens NHWC.
    convert.params_from_flax permutes the flax kernel's input rows so that
    both flattens meet the same weights.
    """

    def __init__(self, in_dim: int, z_dim: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Linear(in_dim, z_dim)

    def forward(self, z):
        return dense(z.flatten(1), self.fc, self.dtype)


class Actor(nn.Module):
    """Linear(z, z) -> ReLU -> Linear(z, action_dim) (train_bc.py:81)."""

    def __init__(self, action_dim: int = 7, z_dim: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(z_dim, z_dim)
        self.fc2 = nn.Linear(z_dim, action_dim)

    def forward(self, h):
        h = F.relu(dense(h, self.fc1, self.dtype))
        return dense(h, self.fc2, self.dtype)
