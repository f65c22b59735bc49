"""VQ-VAE-style conv encoder and decoder (port of
gabril_carla_tpu/models/encoder.py).

Geometry contract (vlm_gaze/models/linear_models.py:124-282): 180x320 input
-> three 4x4/s2/p1 convs (90x160 -> 45x80 -> 22x40) -> 3x3 valid conv
(20x38) -> residual stack -> two 5x5/p2 convs. Flax's explicit pads map to
torch's symmetric ``padding`` (P1 -> 1, "VALID" -> 0, P2 -> 2). The decoder
mirrors it back to 180x320 with transposed convs (``conv_t``).

NCHW here, NHWC in the JAX package. Parameters stay float32; with
``dtype=torch.bfloat16`` every conv casts its input and weights to bf16 and
returns bf16, as flax's ``dtype=bf16`` does with float32 params.

``dropout_mask`` turns on IGMD: gaze-modulated dropout after conv 1 and
conv 2 (linear_models.py:191-199), its expected-value form when
``deterministic``, else the mask of two uniform draws given as ``uniforms``
(one [B, 1, h, w] tensor for each of the two feature maps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gaze import gmd_dropout


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride, layer.padding)


def conv_t(x: torch.Tensor, layer: nn.ConvTranspose2d, dtype: torch.dtype) -> torch.Tensor:
    """Transposed ``layer`` applied in ``dtype``.

    Flax's ConvTranspose (transpose_kernel=False) convolves the
    stride-dilated input, padded by (lo, hi), with its kernel unflipped;
    torch's flips it. So the weight is the flax kernel flipped in H and W
    (convert.py), ``padding = k - 1 - lo`` and ``output_padding = hi - lo``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride,
                              layer.padding, layer.output_padding)


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


def latent_hw(img_height: int, img_width: int) -> tuple[int, int]:
    """The encoder's output size for [H, W] frames: three 4x4/s2/p1 convs
    halve (floor), the 3x3 valid conv takes 2; 180x320 -> 20x38."""
    return img_height // 8 - 2, img_width // 8 - 2


def igmd_hw(img_height: int, img_width: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """Sizes of the two feature maps IGMD drops from (after conv 1, conv 2)."""
    return (img_height // 2, img_width // 2), (img_height // 4, img_width // 4)


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

    def forward(self, x, dropout_mask=None, deterministic: bool = True, uniforms=None):
        dt = self.dtype
        igmd = dropout_mask is not None
        if igmd and not deterministic and (uniforms is None or len(uniforms) != 2):
            raise ValueError("IGMD in train mode needs two uniform tensors")
        x = F.relu(conv(x, self.down1, dt))
        if igmd:
            x = gmd_dropout(x, dropout_mask, test_mode=deterministic,
                            uniforms=None if deterministic else uniforms[0])
        x = F.relu(conv(x, self.down2, dt))
        if igmd:
            x = gmd_dropout(x, dropout_mask, test_mode=deterministic,
                            uniforms=None if deterministic else uniforms[1])
        x = F.relu(conv(x, self.down3, dt))
        x = self.res(conv(x, self.mid, dt))
        x = F.relu(conv(x, self.out1, dt))
        return conv(x, self.out2, dt)


class Decoder(nn.Module):
    """Mirror decoder: [B, embedding_dim, 20, 38] -> [B, out_channels, 180, 320].
    Flax pads (k=3 "VALID"; k=4 ((2, 3), (2, 2)) then P2) become torch's
    (padding, output_padding): 0; (1, (1, 0)) for 22x40 -> 45x80; 1."""

    def __init__(self, embedding_dim: int, out_channels: int = 1, num_hiddens: int = 128,
                 num_residual_layers: int = 2, num_residual_hiddens: int = 32,
                 dtype=torch.float32):
        super().__init__()
        nh = num_hiddens
        self.dtype = dtype
        self.conv_in = nn.Conv2d(embedding_dim, nh, 3, padding=1)
        self.res = ResidualStack(nh, num_residual_layers, num_residual_hiddens, dtype)
        self.up1 = nn.ConvTranspose2d(nh, nh, 3)  # 22x40
        self.up2 = nn.ConvTranspose2d(nh, nh // 2, 4, stride=2, padding=1,
                                      output_padding=(1, 0))  # 45x80
        self.up3 = nn.ConvTranspose2d(nh // 2, nh // 4, 4, stride=2, padding=1)  # 90x160
        self.up4 = nn.ConvTranspose2d(nh // 4, out_channels, 4, stride=2, padding=1)  # 180x320

    def forward(self, x):
        dt = self.dtype
        x = self.res(conv(x, self.conv_in, dt))
        x = F.relu(conv_t(x, self.up1, dt))
        x = F.relu(conv_t(x, self.up2, dt))
        x = F.relu(conv_t(x, self.up3, dt))
        return conv_t(x, self.up4, dt)


class AutoEncoder(nn.Module):
    """Encoder + Decoder: the gaze-predictor model (linear_models.py:356-367)."""

    def __init__(self, in_channels: int, embedding_dim: int = 64, num_hiddens: int = 128,
                 num_residual_layers: int = 2, num_residual_hiddens: int = 32,
                 out_channels: int = 1, dtype=torch.float32):
        super().__init__()
        self.encoder = Encoder(in_channels, embedding_dim, num_hiddens, num_residual_layers,
                               num_residual_hiddens, dtype)
        self.decoder = Decoder(embedding_dim, out_channels, num_hiddens, num_residual_layers,
                               num_residual_hiddens, dtype)

    def forward(self, x, encode_only: bool = False):
        z = self.encoder(x)
        return z if encode_only else self.decoder(z)
