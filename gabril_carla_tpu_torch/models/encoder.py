"""VQ-VAE-style conv encoder (port of gabril_carla_tpu/models/encoder.py).

Geometry contract (vlm_gaze/models/linear_models.py:124-282): 180x320 input
-> three 4x4/s2/p1 convs (90x160 -> 45x80 -> 22x40) -> 3x3 valid conv
(20x38) -> residual stack -> two 5x5/p2 convs. Flax's explicit pads map to
torch's symmetric ``padding`` (P1 -> 1, "VALID" -> 0, P2 -> 2).

NCHW here, NHWC in the JAX package. Parameters stay float32; with
``dtype=torch.bfloat16`` every conv casts its input and weights to bf16 and
returns bf16, as flax's ``dtype=bf16`` does with float32 params.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride, layer.padding)


class Residual(nn.Module):
    def __init__(self, num_hiddens: int, num_residual_hiddens: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv3 = nn.Conv2d(num_hiddens, num_residual_hiddens, 3, padding=1, bias=False)
        self.conv1 = nn.Conv2d(num_residual_hiddens, num_hiddens, 1, bias=False)

    def forward(self, x):
        h = conv(F.relu(x), self.conv3, self.dtype)
        h = conv(F.relu(h), self.conv1, self.dtype)
        return x + h


class ResidualStack(nn.Module):
    def __init__(self, num_hiddens: int, num_residual_layers: int, num_residual_hiddens: int,
                 dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(Residual(num_hiddens, num_residual_hiddens, dtype)
                                    for _ in range(num_residual_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return F.relu(x)


class Encoder(nn.Module):
    """Observation encoder: [B, C, 180, 320] -> [B, embedding_dim, 20, 38]."""

    def __init__(self, in_channels: int, embedding_dim: int = 64, num_hiddens: int = 128,
                 num_residual_layers: int = 2, num_residual_hiddens: int = 32,
                 dtype=torch.float32):
        super().__init__()
        nh = num_hiddens
        self.dtype = dtype
        self.down1 = nn.Conv2d(in_channels, nh // 4, 4, stride=2, padding=1)
        self.down2 = nn.Conv2d(nh // 4, nh // 2, 4, stride=2, padding=1)
        self.down3 = nn.Conv2d(nh // 2, nh, 4, stride=2, padding=1)
        self.mid = nn.Conv2d(nh, nh, 3)
        self.res = ResidualStack(nh, num_residual_layers, num_residual_hiddens, dtype)
        self.out1 = nn.Conv2d(nh, nh, 5, padding=2)
        self.out2 = nn.Conv2d(nh, embedding_dim, 5, padding=2)

    def forward(self, x):
        dt = self.dtype
        x = F.relu(conv(x, self.down1, dt))
        x = F.relu(conv(x, self.down2, dt))
        x = F.relu(conv(x, self.down3, dt))
        x = self.res(conv(x, self.mid, dt))
        x = F.relu(conv(x, self.out1, dt))
        return conv(x, self.out2, dt)
