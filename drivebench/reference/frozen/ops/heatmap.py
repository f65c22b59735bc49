"""Gaze-heatmap generation (port of gabril_carla_tpu/ops/heatmap.py).

Blur is linear, so the blurred delta map of a gaze point is a rank-1 outer
product of two banded-Gaussian matrix rows gathered at its pixel:

    heat[b,t] = sum_p valid_p * outer(Gh[y_p, :], Gw[x_p, :])

a small batched float32 matmul, then per-map min-max normalization
(data_loader_robomimic.py:85-139).

Temporal aggregation (data_loader_robomimic.py:204-278):
  * alpha_decay: per-step normalized heatmaps combined causally with weights
    alpha^(s-j), then re-normalized per step.
  * multiscale: per-step sigma/coeff splats of the raw deltas, causal
    cumulative sum, then one normalization per step.

Stacks sit on axis 1 (NCHW): heat is [B, S, H, W].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .image import format_obs_stack


@functools.lru_cache(maxsize=None)
def gaussian_splat_matrix(size: int, sigma: float) -> np.ndarray:
    """[size, size] banded matrix equal to zero-padded separable Gaussian blur.

    Kernel length is int(4*sigma+1) rounded up to odd, normalized to sum 1
    (data_loader_robomimic.py:71-79).
    """
    ksize = int(4 * sigma + 1)
    if ksize % 2 == 0:
        ksize += 1
    half = ksize // 2
    x = np.arange(ksize, dtype=np.float64) - half
    k1d = np.exp(-(x**2) / (2.0 * sigma**2))
    k1d = k1d / k1d.sum()
    i = np.arange(size)[:, None]
    j = np.arange(size)[None, :]
    d = i - j
    mat = np.where(np.abs(d) <= half, k1d[np.clip(d + half, 0, ksize - 1)], 0.0)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _splat_matrix_on(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """gaussian_splat_matrix as a tensor on ``device``, copied there once."""
    return torch.from_numpy(gaussian_splat_matrix(size, sigma)).to(device)


@functools.lru_cache(maxsize=None)
def _alpha_mix_on(s: int, alpha: float, device: torch.device) -> torch.Tensor:
    """[S, S] causal alpha-decay weights alpha^(s-j) for j <= s, on ``device``."""
    sj = np.arange(s)[:, None] - np.arange(s)[None, :]
    mix = np.where(sj >= 0, alpha ** np.maximum(sj, 0), 0.0).astype(np.float32)
    return torch.from_numpy(mix).to(device)


def _window(center_idx: int, stack_len: int, seq_len: int, device) -> torch.Tensor:
    """stack_window_indices made on ``device`` (a host-to-device copy of the
    indices would wait for the device's queue at every call)."""
    start = center_idx - (stack_len - 1)
    return torch.arange(start, center_idx + 1, device=device).clamp(0, seq_len - 1)


def _normalize_minmax(h: torch.Tensor) -> torch.Tensor:
    """Min-max normalize over the last two (spatial) axes."""
    mn = torch.amin(h, dim=(-2, -1), keepdim=True)
    mx = torch.amax(h, dim=(-2, -1), keepdim=True)
    return (h - mn) / (mx - mn + 1e-8)


class GazeHeatmapper:
    """Gaze preprocessor (GazePreprocessor parity): plain functions of
    tensors, on the device of their inputs."""

    def __init__(
        self,
        img_height: int = 180,
        img_width: int = 320,
        gaze_sigma: float = 30.0,
        gaze_coeff: float = 0.8,
        maxpoints: int = 5,
        temporal_alpha: float = 0.7,
        temporal_mode: str = "alpha_decay",
        temporal_sigmas: tuple[float, ...] | None = None,
        temporal_coeffs: tuple[float, ...] | None = None,
        temporal_offset_start: int = 0,
    ):
        self.img_height = img_height
        self.img_width = img_width
        self.gaze_sigma = float(gaze_sigma)
        self.gaze_coeff = float(gaze_coeff)
        self.maxpoints = int(maxpoints)
        self.temporal_alpha = float(temporal_alpha)
        self.temporal_mode = str(temporal_mode)
        self.temporal_sigmas = tuple(float(s) for s in temporal_sigmas) if temporal_sigmas else None
        self.temporal_coeffs = tuple(float(c) for c in temporal_coeffs) if temporal_coeffs else None
        self.temporal_offset_start = int(max(0, temporal_offset_start))

    def _coords(self, gaze: torch.Tensor):
        """[.., P*2] or [.., P, 2] -> (xi, yi, valid) integer pixel indices."""
        if gaze.shape[-1] == self.maxpoints * 2:
            gaze = gaze.reshape(*gaze.shape[:-1], self.maxpoints, 2)
        gx, gy = gaze[..., 0], gaze[..., 1]
        valid = (gx >= 0) & (gy >= 0)
        xi = (gx.clamp(0.0, 1.0) * (self.img_width - 1)).to(torch.int64).clamp(0, self.img_width - 1)
        yi = (gy.clamp(0.0, 1.0) * (self.img_height - 1)).to(torch.int64).clamp(0, self.img_height - 1)
        return xi, yi, valid.float()

    def _splat(self, gaze: torch.Tensor, sigma: float) -> torch.Tensor:
        """Blurred delta maps for [..., P(, 2)] coords -> [..., H, W]."""
        xi, yi, valid = self._coords(gaze)
        gh = _splat_matrix_on(self.img_height, sigma, gaze.device)
        gw = _splat_matrix_on(self.img_width, sigma, gaze.device)
        rows = gh[yi] * valid[..., None]  # [..., P, H]
        cols = gw[xi]  # [..., P, W]
        return torch.matmul(rows.transpose(-1, -2), cols)

    def heatmaps(self, gaze: torch.Tensor) -> torch.Tensor:
        """Per-step normalized heatmaps: [..., P*2] -> [..., H, W] in [0, 1]
        (data_loader_robomimic.py:85-139)."""
        return _normalize_minmax(self._splat(gaze, self.gaze_sigma))

    def build_stack_heatmaps(self, gaze_seq: torch.Tensor, frame_stack: int,
                             center_idx: int) -> torch.Tensor:
        """Causally aggregated per-stack heatmaps: [B, L, ...] -> [B, S, H, W]
        (data_loader_robomimic.py:204-278)."""
        gaze_stack = gaze_seq[:, _window(center_idx, frame_stack, gaze_seq.shape[1], gaze_seq.device)]
        s = frame_stack

        if self.temporal_mode == "multiscale" and self.temporal_sigmas:
            steps = []
            for j in range(s):
                sig = self.temporal_sigmas[min(self.temporal_offset_start + j, len(self.temporal_sigmas) - 1)]
                coeff = 1.0
                if self.temporal_coeffs:
                    coeff = self.temporal_coeffs[min(self.temporal_offset_start + j, len(self.temporal_coeffs) - 1)]
                steps.append(coeff * self._splat(gaze_stack[:, j], sig))
            return _normalize_minmax(torch.cumsum(torch.stack(steps, 1), 1))

        base = self.heatmaps(gaze_stack)  # [B, S, H, W]
        # causal alpha-decay mix: agg[s] = sum_{j<=s} alpha^(s-j) base[j]
        mix = _alpha_mix_on(s, self.temporal_alpha, base.device)
        return _normalize_minmax(torch.einsum("sj,bjhw->bshw", mix, base))

    def prepare_for_bc(self, obs_image_seq: torch.Tensor, gaze_seq: torch.Tensor, frame_stack: int,
                       grayscale: bool = False, aggregate_stack: bool = True):
        """One-call API for BC training (data_loader_robomimic.py:318-360).

        obs_image_seq [B, L, H, W, C] uint8 or float, gaze_seq [B, L, P*2] or
        [B, L, P, 2] -> (obs [B, S*C', H, W] in [0, 1], heat [B, S, H, W],
        center_idx).
        """
        center_idx = obs_image_seq.shape[1] - 1
        idxs = _window(center_idx, frame_stack, obs_image_seq.shape[1], obs_image_seq.device)
        obs = format_obs_stack(obs_image_seq[:, idxs], grayscale=grayscale)
        if aggregate_stack:
            heat = self.build_stack_heatmaps(gaze_seq, frame_stack, center_idx)
        else:
            heat = self.heatmaps(gaze_seq[:, idxs])
        return obs, heat, center_idx

    def prepare_for_gaze_predictor(self, obs_image_seq: torch.Tensor, gaze_seq: torch.Tensor,
                                   frame_stack: int, grayscale: bool = False):
        """One-call API for gaze-predictor training
        (data_loader_robomimic.py:362-379): (obs [B, S*C', H, W], target
        heatmap [B, 1, H, W], center_idx)."""
        center_idx = obs_image_seq.shape[1] - 1
        idxs = _window(center_idx, frame_stack, obs_image_seq.shape[1], obs_image_seq.device)
        obs = format_obs_stack(obs_image_seq[:, idxs], grayscale=grayscale)
        agg = self.build_stack_heatmaps(gaze_seq, frame_stack, center_idx)  # [B, S, H, W]
        return obs, agg[:, -1:], center_idx
