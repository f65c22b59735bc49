"""4-level UNet gaze model (port of gabril_carla_tpu/models/unet.py; the
reference's models/gaze_predictor.py:6-78, BatchNorm -> GroupNorm).

NCHW here. Convs run in ``dtype``; GroupNorm, as flax's (eps 1e-6, no
dtype of its own), normalizes in float32, so a bf16 model's blocks hand
float32 to the next conv, which casts it back. Transposed convs: flax's
"SAME" for k=2, s=2 is torch's padding 0; d3's ((1, 2), (1, 1)) is padding 0
with output_padding (1, 0), the 22 -> 45 step. Max pooling floors (45 -> 22).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .encoder import conv, conv_t

GN_EPS = 1e-6  # flax GroupNorm's epsilon (torch's default is 1e-5)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


class ConvBlock(nn.Module):
    """Two (3x3 conv, GroupNorm(min(8, C)), relu)."""

    def __init__(self, in_channels: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList([nn.Conv2d(in_channels, features, 3, padding=1),
                                    nn.Conv2d(features, features, 3, padding=1)])
        self.norms = nn.ModuleList([nn.GroupNorm(min(8, features), features, eps=GN_EPS)
                                    for _ in range(2)])

    def forward(self, x):
        for c, n in zip(self.convs, self.norms):
            x = F.relu(F.group_norm(at_least_f32(conv(x, c, self.dtype)), n.num_groups,
                                    n.weight, n.bias, n.eps))
        return x


class UNet(nn.Module):
    """[B, in_channels, 180, 320] -> [B, output_channels, 180, 320]."""

    def __init__(self, in_channels: int, output_channels: int = 1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.e1 = ConvBlock(in_channels, 8, dtype)  # 180x320
        self.e2 = ConvBlock(8, 16, dtype)  # 90x160
        self.e3 = ConvBlock(16, 16, dtype)  # 45x80
        self.e4 = ConvBlock(16, 32, dtype)  # 22x40 (floor)
        self.bott = ConvBlock(32, 32, dtype)  # 11x20
        self.up4 = nn.ConvTranspose2d(32, 32, 2, stride=2)  # 22x40
        self.d4 = ConvBlock(64, 32, dtype)
        self.up3 = nn.ConvTranspose2d(32, 16, 2, stride=2, output_padding=(1, 0))  # 45x80
        self.d3 = ConvBlock(32, 16, dtype)
        self.up2 = nn.ConvTranspose2d(16, 16, 2, stride=2)  # 90x160
        self.d2 = ConvBlock(32, 16, dtype)
        self.up1 = nn.ConvTranspose2d(16, 8, 2, stride=2)  # 180x320
        self.d1 = ConvBlock(16, 8, dtype)
        self.out = nn.Conv2d(8, output_channels, 1)

    def forward(self, x):
        dt = self.dtype
        e1 = self.e1(x)
        e2 = self.e2(F.max_pool2d(e1, 2))
        e3 = self.e3(F.max_pool2d(e2, 2))
        e4 = self.e4(F.max_pool2d(e3, 2))
        bott = self.bott(F.max_pool2d(e4, 2))
        # the skip is float32 (GroupNorm's), the upsampled half in ``dtype``:
        # concatenated in the promoted type, as jnp.concatenate does
        d4 = self.d4(torch.cat([conv_t(bott, self.up4, dt), e4], 1))
        d3 = self.d3(torch.cat([conv_t(d4, self.up3, dt), e3], 1))
        d2 = self.d2(torch.cat([conv_t(d3, self.up2, dt), e2], 1))
        d1 = self.d1(torch.cat([conv_t(d2, self.up1, dt), e1], 1))
        return conv(d1, self.out, dt)
