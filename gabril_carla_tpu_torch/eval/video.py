"""mp4 export of rollout frames (port of gabril_carla_tpu/eval/video.py).

Parity with the reference's per-episode video dump
(eval/my_agents/autonomous_agent.py:118-132: moviepy ImageSequenceClip over
the saved camera frames). The rollout returns the rendered frames
(``make_rollout_fn(..., return_frames=True)``), so export is a host-side
encode through OpenCV's VideoWriter; cv2 is imported only here, so a
machine without it fails on ``--video`` with an ImportError naming cv2.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_mp4(frames: np.ndarray, path: str | Path, fps: float = 20.0) -> Path:
    """Encode frames to mp4.

    frames: [T, H, W] or [T, H, W, C] in float [0, 1] or uint8. Grayscale is
    expanded to BGR. Returns the written path.
    """
    import cv2

    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0.0, 1.0) * 255.0).astype(np.uint8)
    if frames.ndim == 3:
        frames = frames[..., None]
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    t, h, w = frames.shape[:3]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
    try:
        for i in range(t):
            writer.write(frames[i])  # BGR order; grayscale repeats are invariant
    finally:
        writer.release()
    return path
