"""The reference's closed-loop tick and the numbers that judge the port's.

A rollout of thousands of worlds diverges from any second computation of
it within a few ticks (the policy's bf16 rounding moves a steer, the steer
moves the world), so the check follows the port step by step from its own
state. For a sample of worlds of one call it takes what the port captured
at the call's reset and at one tick ``t`` (the states, frames, frame ring,
heat, actions and env draws), works each stage out again from the stage's
inputs, and compares:

* ``frame_px``: the most pixels of one frame (the reset's and tick t's)
  that differ by more than 1e-5 from the plain render of the same state
  (a depth tie may flip a few pixels between the kernel and its plain
  version);
* ``heat_err``: the relative L2 gap (``|a - b| / |b|`` over the sample)
  of the gaze predictor's output (before the clamp to [0, 1]) from the
  UNet run on the port's frame ring (cells with heat);
* ``action_err``: the relative L2 gap of the actions from the policy run on
  the port's ring and heat;
* ``state_err``: the largest gap of a state leaf after the reset and after
  the env step from the port's state, action and the draws worked out from
  the world's key, as ``|a - b| / (1 + |b|)``; a bool or int leaf that
  differs reads at least 0.5;
* ``glue_err``: what joins the stages, exactly: the ring's newest frame is
  tick t's and its older one tick t - 1's (the reset's at t = 0), the heat
  the policy takes is the predictor's output clamped to [0, 1] on every
  frame of the stack, the env step's action is the policy's or the warm-up
  no-op, and the env draws are the key's.

``control`` puts the reference in the port's place computed one precision
lower than the configuration states: the render and the env state rounded
to bf16 (float32 work), the ring stored in bf16, the policy and the UNet
(bf16) with fp8 products.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .frozen.env import state as frozen_state
from .frozen.env.env import DrivingEnv
from .frozen.env.world import load_benchmark_specs, spec_rows, to_torch
from .frozen.ops.raster import render_frame
from .frozen.utils.prng import env_draws
from .lowering import Lowered, round_to
from .models import Policy, f32_only, gaze_model

OFF_PX = 1e-5  # a pixel off by more than this counts
WARMUP_STEPS = 10  # no-op ticks of every episode (bc_agent.py:404)
NUMBERS = ("frame_px", "heat_err", "action_err", "state_err", "glue_err")


def as_frozen(obj):
    """A port state (nested dataclasses of tensors) as the frozen copy's
    classes of the same names."""
    if isinstance(obj, torch.Tensor):
        return obj
    cls = getattr(frozen_state, type(obj).__name__)
    return cls(**{f.name: as_frozen(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def leaves(obj, prefix=""):
    """[(path, tensor)] of a nested dataclass."""
    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    out = []
    for f in dataclasses.fields(obj):
        out += leaves(getattr(obj, f.name), f"{prefix}.{f.name}" if prefix else f.name)
    return out


def state_gap(prog, ref) -> float:
    """Largest ``|a - b| / (1 + |b|)`` over the leaves of two states."""
    worst = 0.0
    pl, rl = dict(leaves(prog)), dict(leaves(ref))
    if pl.keys() != rl.keys():
        return float("inf")
    for k, r in rl.items():
        p = pl[k]
        if p.shape != r.shape:
            return float("inf")
        if not r.is_floating_point():
            worst = max(worst, 0.5 * float((p != r).any()))
            continue
        d = (p.float() - r.float()).abs() / (1.0 + r.float().abs())
        g = float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0
        worst = max(worst, g)
    return worst


def _round_state(st, fmt):
    """Every float leaf of a state rounded to ``fmt``."""
    if isinstance(st, torch.Tensor):
        return round_to(st, fmt) if st.dtype == torch.float32 else st
    return type(st)(**{f.name: _round_state(getattr(st, f.name), fmt) for f in dataclasses.fields(st)})


def _off_px(a, b) -> int:
    d = (a.float() - b.float()).abs().flatten(1)
    d = torch.nan_to_num(d, nan=float("inf"))
    return int((d > OFF_PX).sum(1).max())


def _rel_l2(a, b) -> float:
    d = float(torch.linalg.vector_norm(a.float() - b.float()))
    return d / max(float(torch.linalg.vector_norm(b.float())), 1e-30) if d == d else float("inf")


def _max_abs(a, b) -> float:
    d = (a.float() - b.float()).abs()
    return float(torch.nan_to_num(d, nan=float("inf")).max())


class TickReference:
    """The reference for one cell: its own world compile of the routes, the
    float32 policy and UNet with the benchmark's weights."""

    def __init__(self, cfg, gaze_cfg, routes, params: dict, ticks: int, device):
        f32_only()
        self.specs = load_benchmark_specs(routes)
        self.n_routes = len(routes)
        self.ticks = ticks
        self.device = device
        self.policy = Policy(cfg).to(device).eval()
        self.policy.load_state_dict({k: v for k, v in params.items() if k != "gaze_predictor"})
        self.unet = None
        if gaze_cfg is not None:
            self.unet = gaze_model(gaze_cfg).to(device).eval()
            self.unet.load_state_dict(params["gaze_predictor"])
        self.env = DrivingEnv()

    def spec(self, worlds: np.ndarray):
        return to_torch(spec_rows(self.specs, worlds % self.n_routes), self.device)

    @torch.no_grad()
    def numbers(self, cap: dict, control: bool = False) -> dict:
        """The numbers of one call's capture (module docstring): the port's
        against the reference, or with ``control`` the control's."""
        spec = self.spec(cap["worlds"])
        low = (lambda: Lowered("fp8")) if control else contextlib.nullcontext
        out = {}

        ref0 = self.env.reset(spec)
        st = as_frozen(cap["state_t"])
        frame_reset = render_frame(spec, ref0)
        frame_t = render_frame(spec, st)
        if control:  # the control in the port's place
            prog = {"state0": _round_state(ref0, "bf16"), "frame_reset": round_to(frame_reset, "bf16"),
                    "frame_t": round_to(frame_t, "bf16")}
        else:
            prog = {"state0": as_frozen(cap["state0"]), "frame_reset": cap["frame_reset"],
                    "frame_t": cap["frame_t"]}
        out["frame_px"] = max(_off_px(prog["frame_reset"], frame_reset), _off_px(prog["frame_t"], frame_t))

        ring = cap["ring"]
        prev = cap["frame_prev"] if cap["t"] > 0 else cap["frame_reset"]
        if control:
            ring = round_to(torch.stack([prev, cap["frame_t"]], -1), "bf16")
        glue = [_max_abs(ring[..., -1], cap["frame_t"]), _max_abs(ring[..., 0], prev)]

        obs = ring.permute(0, 3, 1, 2)
        heat = cap["heat"]
        if self.unet is not None:
            raw = cap["heat_raw"].float()
            ref_raw = self.unet(obs).permute(0, 2, 3, 1)
            if control:
                with low():
                    raw = self.unet(obs).permute(0, 2, 3, 1)
                heat = raw.clamp(0.0, 1.0).expand_as(heat)
            out["heat_err"] = _rel_l2(raw, ref_raw)
            glue.append(_max_abs(heat, raw.clamp(0.0, 1.0).expand_as(heat)))
        heat_in = None if heat is None else heat.permute(0, 3, 1, 2)
        ref_action = self.policy(obs, heat_in)
        action = cap["action"]
        if control:
            with low():
                action = self.policy(obs, heat_in)
        out["action_err"] = _rel_l2(action, ref_action)

        noop = torch.zeros(7, device=self.device)
        noop[2] = 1.0
        want = torch.where((st.t < WARMUP_STEPS)[:, None], noop, cap["action"])
        draws = torch.from_numpy(env_draws(cap["keys"], self.ticks)[cap["t"]]).to(self.device)
        glue += [_max_abs(cap["action_env"], want), _max_abs(cap["draws"], draws)]
        out["glue_err"] = max(glue)

        ref1 = self.env.step(spec, st, cap["action_env"], draws)
        if control:
            after = _round_state(self.env.step(spec, _round_state(st, "bf16"), cap["action_env"], draws), "bf16")
        else:
            after = as_frozen(cap["state_t1"])
        out["state_err"] = max(state_gap(prog["state0"], ref0), state_gap(after, ref1))
        return out
