"""The render kernel's function in plain PyTorch, and its constants.

Frozen copy of the port's ops/render_kernel.py with the CUDA build, the
binding and the wrapper taken out: ``render_from_operands`` always runs
``render_from_operands_plain``. Both visit the TPU kernel's row sets: a
ground pixel's depth class (``pixel_classes``) and the per-world count gates
(``row_sets``) pick the distance-sorted rows its argmin runs over.
"""

from __future__ import annotations

import math

import torch

from ..env.constants import LANE_WIDTH

H, W = 180, 320
N_CAM = 18
ROW_COLS = 8
MAX_ROWS = 160  # ROUTE_VIEW route rows + 32 scenario-flow rows
MAX_BOXES = 32
ROUTE_VIEW = 128  # route points visible (1 m spacing; camera depth caps at 120 m)

# camera and shading constants of raster.py / pallas_raster.py (csrc/render.cu
# holds the same values)
FOV_DEG = 60.0
FX = (W / 2) / math.tan(math.radians(FOV_DEG) / 2)
CX, CY = (W - 1) / 2.0, (H - 1) / 2.0
CAM_Z = 1.6  # m above ground
MAX_DEPTH = 120.0
SKY, GRASS, ROAD, MARK = 0.62, 0.42, 0.24, 0.85

# The TPU kernel's row sets (pallas_raster.py:63-83, 179-229). A ground
# pixel's class comes from its bottom-first flat index, (H-1-v)*W + u: the
# class boundaries are the TPU's 32-row x 128-lane tiles 2, 4 and 6. Each
# class runs a prefix of the distance-sorted rows when its row count (cam
# slots 11-14) fits, every row otherwise; with lower_window, classes 2 and
# 3 skip to row LOWER_START after the 4 forced endpoint rows when the lower
# count (slots 16-17) covers the skipped range.
CLASS_PX = (8192, 16384, 24576)
NEAR_PREFIX, NEAR_PREFIX_DECIMATED = (56, 72, 120), (56, 72, 88)
CAP3, CAP3_DECIMATED = 128, 96
LOWER_START = (12, 44)


CHUNK = 8  # worlds a call: the argmin's [B, 87, 320, 160] distance tensor


def render_from_operands(cam_scalars, route_cols, boxes, *, far_decimate: bool = False,
                         lower_window: bool = False) -> torch.Tensor:
    """cam_scalars [B, 18], route_cols [B, R, 8], boxes [B, K, 8] -> frames
    [B, 180, 320] in [0, 1] by the plain version, CHUNK worlds at a time."""
    return torch.cat([render_from_operands_plain(cam_scalars[i:i + CHUNK], route_cols[i:i + CHUNK],
                                                 boxes[i:i + CHUNK], far_decimate=far_decimate,
                                                 lower_window=lower_window)
                      for i in range(0, cam_scalars.shape[0], CHUNK)])


def _clamp(x, lo, hi):
    return x.clamp_min(lo).clamp_max(hi)


def pixel_classes(device="cpu") -> torch.Tensor:
    """[H, W] depth class (0-3) of every pixel, from its bottom-first flat
    index (pallas_raster.py:184-186 with the default 32-row tiles)."""
    v = torch.arange(H, device=device)[:, None]
    u = torch.arange(W, device=device)[None, :]
    flat = (H - 1 - v) * W + u
    return sum((flat >= c).long() for c in CLASS_PX)


def row_sets(cam_scalars, n_rows: int, *, far_decimate: bool = False,
             lower_window: bool = False) -> torch.Tensor:
    """[B, 4, n_rows] bool: the rows a ground pixel of each class visits in
    each world (pallas_raster.py:188-229); every bound is capped at n_rows."""
    n0, n1, n2 = NEAR_PREFIX_DECIMATED if far_decimate else NEAR_PREFIX
    cap3 = CAP3_DECIMATED if far_decimate else CAP3
    lo2, lo3 = LOWER_START
    c = cam_scalars
    k = torch.arange(n_rows, device=c.device)

    def prefix(n):
        return (k < min(n, n_rows)).expand(c.shape[0], -1)

    def window(lo, n):  # the 4 forced endpoint rows, then [lo, n)
        return ((k < min(4, n_rows)) | ((k >= min(lo, n_rows)) & (k < min(n, n_rows)))).expand(
            c.shape[0], -1)

    def gate(cond, rows, otherwise):
        return torch.where(cond[:, None], rows, otherwise)

    every = prefix(n_rows)
    body2 = gate(c[:, 16] >= lo2, window(lo2, n2), prefix(n2)) if lower_window else prefix(n2)
    body3 = gate(c[:, 17] >= lo3, window(lo3, cap3), prefix(cap3)) if lower_window else prefix(cap3)
    return torch.stack([gate(c[:, 11] <= n0, prefix(n0), every),
                        gate(c[:, 12] <= n1, prefix(n1), every),
                        gate(c[:, 13] <= n2, body2, every),
                        gate(c[:, 14] <= cap3 + 0.5, body3, every)], 1)


def render_from_operands_plain(cam_scalars, route_cols, boxes, *, far_decimate: bool = False,
                               lower_window: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each ground pixel's argmin
    over the rows of its class's set (rows outside it can never win), then
    the min-depth composite over the first cam[15] boxes."""
    b = cam_scalars.shape[0]
    dev = cam_scalars.device
    f32 = dict(dtype=torch.float32, device=dev)
    c = [cam_scalars[:, i, None, None] for i in range(10)]
    fwd_x, fwd_y, rgt_x, rgt_y, cloud, start_s, precip, fog, bright, wet = c

    v = torch.arange(H, **f32)[:, None]
    u = torch.arange(W, **f32)[None, :]
    dv = (v - CY).clamp_min(1e-3)
    z = _clamp(torch.tensor(CAM_Z * FX, **f32) / dv, 0.0, MAX_DEPTH)  # [H, 1]
    on_ground = ((v - CY) > 0.5) & (z < MAX_DEPTH)
    vis = MAX_DEPTH * (1.0 - 0.85 * fog)
    sky_col = SKY - 0.15 * cloud
    sky = (sky_col + 0.12 * (v / torch.tensor(float(H), **f32))).expand(b, H, W)

    # terrain, on the ground rows only (a static band of image rows)
    g_rows = on_ground[:, 0].nonzero()[:, 0]
    r0, r1 = int(g_rows[0]), int(g_rows[-1]) + 1
    zg = z[r0:r1]
    x = (u - CX) / torch.tensor(FX, **f32) * zg  # [h, W]
    gx = zg * fwd_x + x * rgt_x  # [B, h, W]
    gy = zg * fwd_y + x * rgt_y
    cols = route_cols
    t = (gx[..., None] * cols[:, None, None, :, 0] + gy[..., None] * cols[:, None, None, :, 1]
         + cols[:, None, None, :, 2])  # [B, h, W, R]
    sets = row_sets(cam_scalars, cols.shape[1], far_decimate=far_decimate,
                    lower_window=lower_window)
    t = t.masked_fill(~sets[:, pixel_classes(dev)[r0:r1]], float("inf"))
    t_min, idx = t.min(-1)  # first minimum, as the kernel's strict '<'
    sel = torch.gather(cols, 1, idx.reshape(b, -1, 1).expand(-1, -1, ROW_COLS)).reshape(
        idx.shape + (ROW_COLS,))
    sel = torch.where((t_min < 1e30)[..., None], sel, 0.0)
    bdx, bdy, be3, bj = sel[..., 3], sel[..., 4], sel[..., 5], sel[..., 6]
    lat = bdy * gx - bdx * gy + be3
    near_s = start_s + bj
    is_route = bj < float(ROUTE_VIEW)
    hi = torch.where(is_route, 1.5 * LANE_WIDTH + 0.3, 0.5 * LANE_WIDTH + 0.3)
    on_road = (lat > -0.5 * LANE_WIDTH - 0.3) & (lat < hi)
    dash = torch.remainder(near_s, 4.0) < 2.0  # floor mod, as jnp.mod
    centre = ((lat - 0.5 * LANE_WIDTH).abs() < 0.12) & dash & is_route
    edge = (((lat + 0.5 * LANE_WIDTH).abs() < 0.15)
            | ((lat - 1.5 * LANE_WIDTH).abs() < 0.15)) & is_route
    road_col = ROAD * (1.0 - 0.30 * wet)
    terrain = torch.where(on_road, road_col, torch.tensor(GRASS, **f32))
    terrain = torch.where(centre | edge, torch.tensor(MARK, **f32), terrain)
    fade_coef = 0.25 + 0.75 * fog
    fade = _clamp(zg / vis, 0.0, 1.0) * fade_coef
    terrain = terrain * (1.0 - fade) + sky_col * fade
    img = sky.clone()
    img[:, r0:r1] = torch.where(on_ground[r0:r1], terrain, sky[:, r0:r1])

    # min-depth composite over the visible boxes (first of equal depths wins)
    bx = boxes[:, :, None, None, :]  # [B, K, 1, 1, 8]
    shown = torch.arange(boxes.shape[1], device=dev)[None, :] < cam_scalars[:, 15:16]
    inside = ((u >= bx[..., 0]) & (u <= bx[..., 1]) & (v >= bx[..., 2]) & (v <= bx[..., 3])
              & (bx[..., 6] > 0.5) & shown[..., None, None])  # [B, K, H, W]
    depth = torch.where(inside, bx[..., 4], torch.tensor(1e30, **f32))
    best_d, best = depth.min(1)  # [B, H, W]
    best_c = torch.gather(boxes[..., 5], 1, best.reshape(b, -1)).reshape(best.shape)
    shade = 1.0 - _clamp(best_d / MAX_DEPTH, 0.0, 0.6)
    afog = _clamp(best_d / vis, 0.0, 1.0) * (0.8 * fog)
    img = torch.where(best_d < 1e29, best_c * shade * (1.0 - afog) + sky_col * afog, img)
    img = img * (1.0 - 0.2 * precip) + 0.5 * (0.2 * precip)
    img = img * bright
    return _clamp(img, 0.0, 1.0)
