"""The least time for the render kernel K1's work on given operands.

A copy of chip_smoke.py's ``bound`` (default flags), reading the render
constants from the frozen copy of the render module, so that it imports
nothing of the port. Bytes: each input read once, the frames written once,
over the memory rate. Operations: the argmin costs 5 per row a ground pixel
visits (two FMAs and a compare), summed over each pixel's class set on these
operands (``row_sets``); the composite 5 per pixel a visible box covers,
each box's area clipped to the frame; shading is not counted. One
operation is one float32 flop against the 67 TFLOP/s rate outside the
tensor cores. The larger of the two times bounds the kernel.
"""

from __future__ import annotations

import torch

from ..reference.frozen.ops import render_kernel as K
from .peaks import BYTES_S, F32_S


def k1_bound_s(cam: torch.Tensor, n_rows: int, boxes: torch.Tensor) -> tuple[float, str]:
    """(seconds, "operations" or "bytes") for one launch on ``cam`` [B, 18],
    ``n_rows`` route rows a world and ``boxes`` [B, K, 8]."""
    dev = cam.device
    v = torch.arange(K.H, dtype=torch.float32, device=dev)
    z = (torch.tensor(K.CAM_Z * K.FX, device=dev) / (v - K.CY).clamp_min(1e-3)).clamp(0.0, K.MAX_DEPTH)
    ground = ((v - K.CY) > 0.5) & (z < K.MAX_DEPTH)  # [H]
    cls = K.pixel_classes(dev)
    px_per_class = torch.stack([((cls == c) & ground[:, None]).sum() for c in range(4)]).double()
    row_visits = (K.row_sets(cam, n_rows).sum(-1).double() * px_per_class).sum().item()
    shown = (torch.arange(boxes.shape[1], device=dev)[None] < cam[:, 15:16]) & (boxes[..., 6] > 0.5)
    n_u = (boxes[..., 1].clamp(max=K.W - 1).floor() - boxes[..., 0].clamp(min=0).ceil() + 1).clamp(min=0)
    n_v = (boxes[..., 3].clamp(max=K.H - 1).floor() - boxes[..., 2].clamp(min=0).ceil() + 1).clamp(min=0)
    box_px = (n_u.double() * n_v.double() * shown).sum().item()
    ops_n = 5.0 * row_visits + 5.0 * box_px
    b = cam.shape[0]
    bytes_n = 4.0 * (cam.numel() + b * n_rows * K.ROW_COLS + boxes.numel() + b * K.H * K.W)
    t_ops, t_bytes = ops_n / F32_S, bytes_n / BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
