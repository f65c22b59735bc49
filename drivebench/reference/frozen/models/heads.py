"""MLP heads: pre-actor projection, actor, GRIL coordinate head, projector
(port of gabril_carla_tpu/models/heads.py).

Parity: linear_models.py:302-353 and the heads train/train_bc.py:73-86
builds (pre_actor = Flatten + Linear(z_dim); actor = Linear-ReLU-Linear;
GRIL's head = MLP with hidden_depth 1, built in train/bc.py).
Parameters stay float32; each Linear runs in the module's ``dtype``. torch
needs each layer's input width, which flax infers: ``mlp_head`` and
``Projector`` take it first.
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


def mlp_head(in_dim: int, hidden_dim: int | None, output_dim: int, hidden_depth: int,
             dtype=torch.float32) -> MLP:
    """An MLP equivalent to linear_models.mlp, on ``in_dim`` inputs."""
    return MLP(in_dim, output_dim, hidden_dim=hidden_dim, hidden_depth=hidden_depth, dtype=dtype)


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


class Projector(nn.Module):
    """General projection MLP (linear_models.py:343-353)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 256, hidden_depth: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.mlp = MLP(in_dim, out_dim, hidden_dim=hidden_dim, hidden_depth=hidden_depth, dtype=dtype)

    def forward(self, h):
        return self.mlp(h)
