"""Pseudo-gaze generation: detector boxes -> gaze coordinate streams (port of
gabril_carla_tpu/saliency/pseudo_gaze.py).

Rebuild of the saliency_pipeline sub-project's offline tooling
(saliency_pipeline/vlm_filter.py + convert_bbox_to_dataset.py: GroundingDINO
detections filtered by Qwen2.5-VL, bbox centers written as gaze_pseudo.pt /
filter_dynamic.pt / non_filter.pt variants).

Detectors are pluggable:
  * SceneGraphDetector — ground-truth actor boxes projected from the scene
    graph (``scene_boxes`` on the rollout's states: no network, exact), with
    a dynamic-only filter matching the 'filter_dynamic' variant.
  * ExternalVLMDetector — the interface for the reference's VLM path; it
    calls a user-provided detector function, since VLM inference is an
    external, offline dependency.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Protocol

import numpy as np
import torch

from ..data.converter import coerce_gaze
from ..ops.raster import _camera_basis, _collect_actor_boxes


def scene_boxes(state) -> torch.Tensor:
    """[B, A, 8] screen boxes of every actor in the worlds of ``state``, as
    the renderer draws them (ops/raster.py _collect_actor_boxes columns:
    u0 u1 v0 v1 depth color ok pad)."""
    return _collect_actor_boxes(state, *_camera_basis(state.ego.pos, state.ego.yaw))


def bboxes_to_gaze_coords(boxes: list[np.ndarray], t: int, hw: tuple[int, int],
                          max_points: int = 5) -> np.ndarray:
    """Per-frame [K, 4] pixel bboxes -> [T, max_points*2] normalized centers.

    (-1, -1) padding, center = box midpoint — convert_bbox_to_dataset parity.
    """
    return coerce_gaze(boxes, t, hw, max_points)


class Detector(Protocol):
    def __call__(self, frame_idx: int) -> np.ndarray:  # [K, 4] pixel boxes
        ...


class SceneGraphDetector:
    """Ground-truth detector over recorded rollout states.

    Args:
        screen_boxes: [T, A, 8] per-tick actor screen boxes of one world
            (``scene_boxes`` columns: u0 u1 v0 v1 depth color ok)
        dynamic_only: keep vehicles/walkers, drop statics ('filter_dynamic').
    """

    def __init__(self, screen_boxes: np.ndarray, dynamic_cols: np.ndarray | None = None,
                 dynamic_only: bool = False, max_depth: float = 80.0):
        self.boxes = np.asarray(screen_boxes)
        self.dynamic = dynamic_cols
        self.dynamic_only = dynamic_only
        self.max_depth = max_depth

    def __call__(self, frame_idx: int) -> np.ndarray:
        b = self.boxes[frame_idx]
        ok = (b[:, 6] > 0.5) & (b[:, 4] < self.max_depth)
        if self.dynamic_only and self.dynamic is not None:
            ok &= self.dynamic
        sel = b[ok]
        order = np.argsort(sel[:, 4])  # nearest first
        sel = sel[order]
        return sel[:, [0, 2, 1, 3]]  # -> x0 y0 x1 y1


class ExternalVLMDetector:
    """Adapter for an external VLM detection callable (GroundingDINO/Qwen
    class of pipelines). The callable maps an RGB frame -> [K, 4] pixel boxes;
    absent one, raises with guidance instead of silently returning nothing."""

    def __init__(self, detect_fn: Callable[[np.ndarray], np.ndarray] | None, frames: np.ndarray):
        if detect_fn is None:
            raise RuntimeError(
                "ExternalVLMDetector needs a detection callable (external VLM "
                "inference is not bundled); use SceneGraphDetector for "
                "in-sim pseudo-gaze, or supply detect_fn=lambda frame: boxes."
            )
        self.detect_fn = detect_fn
        self.frames = frames

    def __call__(self, frame_idx: int) -> np.ndarray:
        return np.asarray(self.detect_fn(self.frames[frame_idx]), np.float32).reshape(-1, 4)


def generate_pseudo_gaze(
    episode_dir: str | Path,
    detector: Detector,
    t: int,
    hw: tuple[int, int],
    variant: str = "gaze_pseudo",
    max_points: int = 5,
) -> Path:
    """Write <episode>/<variant>.npz with [T, max_points*2] coords."""
    boxes = [detector(i) for i in range(t)]
    coords = bboxes_to_gaze_coords(boxes, t, hw, max_points)
    out = Path(episode_dir) / f"{variant}.npz"
    np.savez_compressed(out, gaze=coords)
    return out
