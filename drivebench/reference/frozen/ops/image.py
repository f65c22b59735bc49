"""Image primitives (port of gabril_carla_tpu/ops/image.py).

Resizes are dense interpolation-weight matrices applied with two float32
matmuls (``out = Wh @ img @ Ww^T``). Numeric contract: torch
``interpolate(mode='bicubic', align_corners=False)`` (cubic convolution
a=-0.75, half-pixel centres, clamped borders), which the reference uses for
gaze-mask upsampling (vlm_gaze/data_utils/gaze_utils.py:19,39).

NCHW here: a frame stack is [B, S*C', H, W] where the JAX package keeps
[B, H, W, S*C'].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Luma coefficients used throughout the reference
# (vlm_gaze/data_utils/data_loader_robomimic.py:193).
_LUMA = (0.299, 0.587, 0.114)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys), a=-0.75 as in torch bicubic."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


@functools.lru_cache(maxsize=None)
def bicubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] bicubic interpolation matrix (numpy; the JAX
    package's, bit for bit). Half-pixel mapping, clamped borders, row sums 1."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    i = np.arange(out_size, dtype=np.float64)
    center = (i + 0.5) * scale - 0.5
    i0 = np.floor(center).astype(np.int64)
    t = center - i0  # in [0, 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(i0 + tap, 0, in_size - 1)
        w = _cubic_kernel(t - tap)
        np.add.at(mat, (np.arange(out_size), idx), w)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_matrix_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """bicubic_resize_matrix as a tensor on ``device``, copied there once."""
    return torch.from_numpy(bicubic_resize_matrix(in_size, out_size)).to(device)


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic resize of [..., H, W] by two float32 matmuls. The JAX package
    pins precision="highest" here; on the card TF32 stays off
    (train/bc.py: full_f32)."""
    h, w = img.shape[-2], img.shape[-1]
    if h == out_h and w == out_w:
        return img
    wh = _resize_matrix_on(h, out_h, img.device)
    ww = _resize_matrix_on(w, out_w, img.device)
    return torch.matmul(torch.matmul(wh, img.float()), ww.T)


def rgb_to_grayscale(img: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """Luma grayscale with the reference's coefficients; keeps a singleton
    channel at ``channel_axis``."""
    r, g, b = torch.split(img, 1, dim=channel_axis)
    return _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b


def stack_window_indices(center_idx: int, stack_len: int, seq_len: int) -> np.ndarray:
    """Frame-stack gather indices [center-S+1, ..., center] clamped into
    [0, L-1] (data_loader_robomimic.py:144-157)."""
    start = center_idx - (stack_len - 1)
    idxs = np.clip(np.arange(start, center_idx + 1), 0, seq_len - 1)
    return idxs.astype(np.int32)


def format_obs_stack(images: torch.Tensor, grayscale: bool) -> torch.Tensor:
    """[B, S, H, W, C] uint8/float -> encoder-ready NCHW [B, S*C', H, W].

    uint8 is divided by 255.0; optional luma conversion (C'=1). Channels are
    (s, c) flattened, frame-major, as the reference's
    'b s c h w -> b (s c) h w' (data_loader_robomimic.py:194).
    """
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    b, s, h, w, c = images.shape
    if grayscale and c == 3:
        images = rgb_to_grayscale(images, channel_axis=-1)
        c = 1
    return images.permute(0, 1, 4, 2, 3).reshape(b, s * c, h, w)
