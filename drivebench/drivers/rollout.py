"""Eval cells: the port's closed loop (eval/rollout.py make_rollout_fn) with
the BC policy (train/bc.py make_bc_policy_fn) and, where the configuration
has a gaze predictor, the UNet's heat every tick
(train/gaze_predictor.py make_gaze_predictor_apply).

The worlds are the traffic's routes compiled by the port
(env/world.py load_benchmark_specs) and tiled to the cell's world count.
Each call of the window is ``ticks_per_call`` ticks from a reset, on fresh
per-world threefry keys drawn from the seed; calls run back to back.

``Taps`` wraps the functions the rollout calls each tick (the render, the
heat, the policy, the env step) in a ``drivebench.<stage>`` span each,
without a synchronize, and copies a sample of worlds' inputs and outputs
at the reset and at one tick of each call for the output check
(reference/rollout.py). During the traced stretch it also keeps the render
kernel's operands, for its bound.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from unittest import mock

import numpy as np
import torch
from torch.profiler import record_function

from ..common import SPAN, host_rng, make_params, sync
from ..counts import flops as F
from ..counts.k1_bound import k1_bound_s
from ..reference.rollout import NUMBERS, TickReference
from ..trace import Stretch


def take(obj, idx):
    """Rows ``idx`` of every tensor of ``obj`` (a tensor or nested
    dataclasses of per-world tensors), copied."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.index_select(0, idx)
    return type(obj)(**{f.name: take(getattr(obj, f.name), idx) for f in dataclasses.fields(obj)})


CAPTURED = {"state0", "frame_reset", "frame_t", "ring", "heat", "action", "state_t", "action_env",
            "draws", "state_t1"}


@dataclasses.dataclass
class Plan:
    keys: np.ndarray  # [B, 2] uint32, the call's keys
    t: int  # the tick whose stages are copied
    worlds: np.ndarray  # the sampled worlds
    idx: torch.Tensor  # the same on the device


class Taps:
    """Spans around the program's tick stages, and the sample's copies."""

    def __init__(self):
        self.tick = -2
        self.plan = None
        self.cap = None
        self.on_tick = None
        self.k1_ops = None

    def begin(self, plan):
        self.tick, self.plan = -2, plan
        self.cap = None if plan is None else {"worlds": plan.worlds, "t": plan.t,
                                              "keys": plan.keys[plan.worlds]}

    def _now(self):
        return self.plan is not None and self.tick == self.plan.t

    def render(self, fn):
        def render(spec, state, **kw):
            self.tick += 1  # -1: the reset's frame
            if self.on_tick is not None:
                self.on_tick(self.tick)
            with record_function(SPAN + "render"):
                frame = fn(spec, state, **kw)
            p = self.plan
            if p is not None:
                if self.tick == -1:
                    self.cap.update(state0=take(state, p.idx), frame_reset=take(frame, p.idx))
                if self.tick == p.t - 1 and p.t > 0:
                    self.cap["frame_prev"] = take(frame, p.idx)
                if self.tick == p.t:
                    self.cap["frame_t"] = take(frame, p.idx)
            return frame

        return render

    def k1(self, fn):
        def render_from_operands(cam, rows, boxes, **kw):
            if self.k1_ops is not None:
                self.k1_ops.append((cam, rows.shape[1], boxes))
            return fn(cam, rows, boxes, **kw)

        return render_from_operands

    def heat(self, fn):
        def heat(params, obs):
            with record_function(SPAN + "heat"):
                out = fn(params, obs)
            if self._now():
                self.cap["heat_raw"] = take(out, self.plan.idx)
            return out

        return heat

    def policy(self, fn):
        def policy(params, obs, heat=None):
            with record_function(SPAN + "policy"):
                action = fn(params, obs, heat)
            if self._now():
                idx = self.plan.idx
                self.cap.update(ring=take(obs, idx), heat=take(heat, idx), action=take(action, idx))
            return action

        return policy

    def env(self, base):
        taps = self

        class Env(base):
            def step(self, spec, state, action, draws):
                with record_function(SPAN + "env_step"):
                    out = super().step(spec, state, action, draws)
                if taps._now():
                    idx = taps.plan.idx
                    taps.cap.update(state_t=take(state, idx), action_env=take(action, idx),
                                    draws=take(draws, idx), state_t1=take(out, idx))
                return out

        return Env


class Cell:
    rate_metric = "env_steps_per_s"

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.worlds, self.ticks = t["worlds"], t["ticks_per_call"]
        self.per_unit = self.worlds  # a unit of the rate is a world-tick
        self.cfg = copy.deepcopy(ctx.config["policy"])
        self.gaze_cfg = copy.deepcopy(ctx.config.get("gaze_predictor"))
        self.units_done = 0
        self.calls = 0
        self.caps = []
        self.patches = contextlib.ExitStack()

    def setup(self):
        from gabril_carla_tpu_torch.env.world import load_benchmark_specs, spec_rows, to_torch
        from gabril_carla_tpu_torch.eval import rollout as RO
        from gabril_carla_tpu_torch.ops import raster
        from gabril_carla_tpu_torch.train.bc import build_bc_models, make_bc_policy_fn
        from gabril_carla_tpu_torch.utils.config import Config

        ctx, dev = self.ctx, self.ctx.device
        routes = ctx.traffic["routes"]
        specs = load_benchmark_specs(routes)
        self.spec = to_torch(spec_rows(specs, np.arange(self.worlds) % len(routes)), dev)
        cfg = Config(copy.deepcopy(self.cfg))
        models = build_bc_models(cfg, dev)
        scale = ctx.config.get("init_scale", {})
        self.params = make_params({k: tuple(v.shape) for k, v in models.state_dict().items()},
                                  ctx.seed, "policy", dev, scale.get("policy"))
        self.taps = taps = Taps()
        gp = None
        if self.gaze_cfg is not None:
            from gabril_carla_tpu_torch.train.gaze_predictor import build_gaze_models, make_gaze_predictor_apply

            gmodel, _ = build_gaze_models(Config(copy.deepcopy(self.gaze_cfg)), dev)
            self.params["gaze_predictor"] = make_params(
                {k: tuple(v.shape) for k, v in gmodel.state_dict().items()}, ctx.seed, "gaze_predictor", dev,
                scale.get("gaze_predictor"))
            gp = taps.heat(make_gaze_predictor_apply(gmodel))
        self.patches.enter_context(mock.patch.object(RO, "render_frame", taps.render(RO.render_frame)))
        self.patches.enter_context(mock.patch.object(RO, "DrivingEnv", taps.env(RO.DrivingEnv)))
        self.patches.enter_context(mock.patch.object(raster, "render_from_operands",
                                                     taps.k1(raster.render_from_operands)))
        self.rollout = RO.make_rollout_fn(taps.policy(make_bc_policy_fn(models, cfg)), cfg,
                                          steps=self.ticks, gaze_predictor_apply=gp)
        self._call(self._plan("warm-up", sample=False))
        sync(dev)

    def _plan(self, call, sample: bool = True) -> Plan:
        rng = host_rng(self.ctx.seed, "call", call)
        keys = rng.integers(0, 2**32, size=(self.worlds, 2), dtype=np.uint32)
        t = int(rng.integers(0, self.ticks))
        n = min(self.ctx.traffic["sample_worlds"], self.worlds) if sample else 0
        worlds = np.sort(rng.choice(self.worlds, size=n, replace=False))
        return Plan(keys, t, worlds, torch.from_numpy(worlds).to(self.ctx.device))

    def _call(self, plan: Plan, capture: bool = False):
        self.taps.begin(plan if capture else None)
        self.rollout(self.spec, self.params, plan.keys)
        return self.taps.cap

    def run_unit(self):
        self.caps.append(self._call(self._plan(self.calls), capture=True))
        self.calls += 1
        self.units_done += self.worlds * self.ticks

    def trace(self):
        t = self.ctx.traffic
        k0, n = t["trace_from_tick"], t["trace_ticks"]
        stretch = Stretch(self.ctx.device, n)
        self.taps.k1_ops = []

        def on_tick(tick):
            if tick == k0:
                stretch.start()
                self.taps.k1_ops = []
            elif tick == k0 + n:
                stretch.stop()
                self.k1_ops, self.taps.k1_ops = self.taps.k1_ops, None

        self.taps.on_tick = on_tick
        self._call(self._plan("traced", sample=False))
        self.taps.on_tick = None
        return stretch.read()

    def flops_per_unit(self) -> dict:
        """Per tick."""
        return F.eval_tick(self.cfg, self.gaze_cfg, self.worlds)

    def k1_bound(self) -> tuple[float, int] | None:
        """(the least seconds for the traced K1 launches' work, launches)."""
        ops = getattr(self, "k1_ops", None)
        return (sum(k1_bound_s(c, n, b)[0] for c, n, b in ops), len(ops)) if ops else None

    def free_program(self):
        self.patches.close()
        self.rollout = self.spec = self.taps = None

    def check(self) -> dict:
        ref = TickReference(self.cfg, self.gaze_cfg, self.ctx.traffic["routes"], self.params,
                            self.ticks, self.ctx.device)
        out = {}
        need = CAPTURED | ({"heat_raw"} if self.gaze_cfg is not None else set())
        for cap in self.caps:
            if not need <= cap.keys():  # a stage the window never ran
                return dict.fromkeys(NUMBERS, float("inf"))
            for k, v in ref.numbers(cap).items():
                out[k] = max(out.get(k, 0.0), v if v == v else float("inf"))
        return {k: out[k] for k in NUMBERS if k in out}
