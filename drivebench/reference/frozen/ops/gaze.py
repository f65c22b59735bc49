"""GABRIL gaze math (port of gabril_carla_tpu/ops/gaze.py): saliency masks
from an encoder latent and gaze-modulated dropout
(vlm_gaze/data_utils/gaze_utils.py:7-52). NCHW: a latent is [B, C, h, w].
"""

from __future__ import annotations

import torch

from .image import resize_bicubic


def gaze_mask_from_latent(z: torch.Tensor, beta: float, target_hw: tuple[int, int]) -> torch.Tensor:
    """Saliency mask [B, H, W] in [0, 1] from a latent [B, C, h, w]:
    channel-abs-sum -> softmax over locations at temperature ``beta`` ->
    bicubic upsample -> per-sample min-max (gaze_utils.get_gaze_mask).

    amax/amin split their gradient evenly over tied elements, as jnp.max and
    jnp.min do.
    """
    b, _, h, w = z.shape
    sal = torch.sum(torch.abs(z), dim=1)  # [B, h, w]
    p = torch.softmax(sal.reshape(b, h * w).float() / beta, dim=-1).reshape(b, h, w)
    up = resize_bicubic(p, target_hw[0], target_hw[1])  # [B, H, W]
    mx = torch.amax(up, dim=(1, 2), keepdim=True)
    mn = torch.amin(up, dim=(1, 2), keepdim=True)
    return (up - mn) / (mx - mn)


def gmd_dropout(z: torch.Tensor, g: torch.Tensor, test_mode: bool = False,
                uniforms: torch.Tensor | None = None, dropout_prob: float = 0.7) -> torch.Tensor:
    """Gaze-modulated dropout (gaze_utils.apply_gmd_dropout).

    Keep-probability map K = p * minmax(resize(mean_s(g))) + (1 - p), with the
    min and max over the whole batch tensor (the reference's
    ``K.max() - K.min()``). Test mode multiplies z by K; train mode by the
    mask ``a < K`` for the uniforms ``a [B, 1, h, w]`` of JAX's key
    (train/bc.py step_draws draws them: ops/threefry_kernel.py).

    z [B, C, h, w]; g [B, H, W] or [B, S, H, W] (stack on axis 1).
    """
    b, _, h, w = z.shape
    gm = g.float() if g.dim() == 3 else g.float().mean(dim=1)  # [B, H, W]
    k = resize_bicubic(gm, h, w)  # [B, h, w]
    denom = torch.amax(k) - torch.amin(k)
    k = (k - torch.amin(k)) / (denom + 1e-8)
    k = (dropout_prob * k + (1.0 - dropout_prob))[:, None]  # [B, 1, h, w]
    if test_mode:
        return z * k
    if uniforms is None:
        raise ValueError("gmd_dropout in train mode needs its uniforms")
    if uniforms.shape != (b, 1, h, w):
        raise ValueError(f"gmd_dropout uniforms must be {(b, 1, h, w)}, got {tuple(uniforms.shape)}")
    return z * (uniforms < k).to(z.dtype)
