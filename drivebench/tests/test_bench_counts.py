"""The benchmark's yardsticks against hand counts and torch's own FLOP
counter, on the CPU at small sizes."""

from __future__ import annotations

import copy
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from drivebench.common import load_json, make_params, ROOT
from drivebench.counts import flops as F
from drivebench.counts.k1_bound import k1_bound_s
from drivebench.counts.peaks import BYTES_S, F32_S
from drivebench.reference import models as M
from drivebench.reference.frozen.ops import render_kernel as K

REG = load_json(ROOT / "drivebench/configs/reg.json")["policy"]
MASK = load_json(ROOT / "drivebench/configs/mask_unet.json")


def small(cfg, h=24, w=48, hiddens=16):
    cfg = copy.deepcopy(cfg)
    cfg["data"].update(img_height=h, img_width=w)
    cfg["model"].update(num_hiddens=hiddens, num_residual_hiddens=8, embedding_dim=8, z_dim=32)
    return cfg


def counted(fn) -> int:
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


def test_conv_by_hand():
    # 2 flops a multiply-add: a 3x3 conv of 4 -> 5 channels on an 8x6 output
    assert F._conv(4, 5, 3, 8, 6) == 2 * 4 * 5 * 9 * 48
    assert F._out(180, 4, 2, 1) == 90 and F._out(45, 4, 2, 1) == 22 and F._out(22, 3) == 20


def test_policy_layers_by_hand():
    cfg = small(REG)  # 24x48 -> 12x24 -> 6x12 -> 3x6 -> 1x4
    nh, r, e, z = 16, 8, 8, 32
    want = [2 * 2 * 4 * 16 * 12 * 24, 2 * 4 * 8 * 16 * 6 * 12, 2 * 8 * 16 * 16 * 3 * 6,
            2 * 16 * 16 * 9 * 4] + [2 * nh * r * 9 * 4, 2 * r * nh * 4] * 2 + \
        [2 * nh * nh * 25 * 4, 2 * nh * e * 25 * 4, 2 * e * 4 * z, 2 * z * z, 2 * z * 7]
    assert F.policy_layers(cfg) == want


def test_policy_forward_matches_flop_counter():
    cfg = REG
    pol = M.Policy(cfg)
    x = torch.rand(2, 2, 180, 320)
    assert counted(lambda: pol(x)) == 2 * sum(F.policy_layers(cfg))


def test_bc_step_matches_flop_counter():
    cfg = small(REG)
    pol = M.Policy(cfg)
    params = make_params({k: tuple(v.shape) for k, v in pol.state_dict().items()}, 1, "w", "cpu")
    from drivebench.drivers.train import make_batch

    batch = make_batch(cfg, 3, 1, 0, "cpu", True)

    def step():
        live = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = M.bc_loss(pol, cfg, live, batch)
        torch.autograd.grad(loss, list(live.values()))

    want = F.bc_train_step(cfg, 3)
    assert counted(step) == want["bf16"] + want["f32"]


def test_unet_and_gaze_step_match_flop_counter():
    cfg = small(MASK["gaze_predictor"], h=36, w=48)  # 36 -> 18 -> 9 -> 4: the 180-row odd level
    unet = M.gaze_model(cfg)
    assert counted(lambda: unet(torch.rand(2, 2, 36, 48))) == 2 * sum(F.unet_layers(cfg))
    params = make_params({k: tuple(v.shape) for k, v in unet.state_dict().items()}, 1, "w", "cpu")
    from drivebench.drivers.train import make_batch

    batch = make_batch(cfg, 2, 1, 0, "cpu", False)

    def step():
        live = {k: v.clone().requires_grad_() for k, v in params.items()}
        torch.autograd.grad(M.gaze_loss(unet, cfg, live, batch), list(live.values()))

    want = F.gaze_train_step(cfg, 2)
    assert counted(step) == want["bf16"] + want["f32"]


def test_eval_tick_counts_policy_and_unet():
    tick = F.eval_tick(MASK["policy"], MASK["gaze_predictor"], 3)
    assert tick["bf16"] == 3 * (sum(F.policy_layers(MASK["policy"])) + sum(F.unet_layers(MASK["gaze_predictor"])))
    assert F.eval_tick(REG, None, 5) == {"bf16": 5 * sum(F.policy_layers(REG)), "f32": 0}


def _ground_rows():
    n = 0
    for v in range(K.H):
        dv = max(v - K.CY, 1e-3)
        z = min(max(K.CAM_Z * K.FX / dv, 0.0), K.MAX_DEPTH)
        n += (v - K.CY) > 0.5 and z < K.MAX_DEPTH
    return n


def test_k1_bound_by_hand():
    b, rows = 3, 160
    cam = torch.zeros(b, K.N_CAM)
    cam[:, 11:15] = 1e9  # every count gate fails: every ground pixel visits every row
    boxes = torch.zeros(b, 32, 8)
    boxes[0, 0] = torch.tensor([10.0, 19.0, 20.0, 24.0, 5.0, 0.5, 1.0, 0.0])  # a 10 x 5 box
    cam[0, 15] = 1.0
    ground_px = _ground_rows() * K.W
    ops = 5.0 * b * ground_px * rows + 5.0 * 50
    nbytes = 4.0 * (cam.numel() + b * rows * 8 + boxes.numel() + b * K.H * K.W)
    t, by = k1_bound_s(cam, rows, boxes)
    assert by == "operations"
    assert math.isclose(t, max(ops / F32_S, nbytes / BYTES_S), rel_tol=1e-12)
