"""Optimizer and LR schedules (port of gabril_carla_tpu/train/optim.py).

Written to optax's numbers, not torch.optim's: the JAX package builds

    adam:  clip_by_global_norm -> add_decayed_weights (L2, ahead of the
           moments, as torch.optim.Adam) -> scale_by_adam -> -lr(count)
    adamw: clip_by_global_norm -> scale_by_adam -> add_decayed_weights -> -lr

wrapped in optax.MultiSteps for gradient accumulation and in optax.masked
for Oreo's frozen quantizer. So: the clip divides by the global norm with no
epsilon (torch's clip_grad_norm_ adds 1e-6); Adam's eps 1e-8 sits outside
the square root, with bias correction; the schedule is a function of the
count of applied updates, starting at 0; accumulation keeps a running mean
of k gradients and applies one update every k steps, a zero update between.

Schedules (vlm_gaze/train/common/optim.py:11-107): step, cosine (per
epoch), cosine_warm_restarts, cosine_warmup (per-step linear warmup, cosine
to eta_min), onecycle (optax.cosine_onecycle_schedule), none. They are
evaluated on the host in float64 from the update count, which lives on the
host, so no step waits for the device.

Parameters, gradients and moments are flat dicts of tensors; every update
returns new tensors and leaves its inputs as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


def _schedule(cfg_sched, cfg_train, base_lr: float, steps_per_epoch: int,
              grad_accum: int = 1) -> Callable[[int], float] | float:
    kind = cfg_sched.get("type") or "none"
    epochs = cfg_train.get("epochs", 1)
    spe = max(1, steps_per_epoch // max(1, grad_accum))

    if kind == "none":
        return base_lr

    if kind == "step":
        # StepLR: lr * gamma^(epoch // step_size), stepped per epoch
        def fn(step):
            epoch = step // spe
            return base_lr * cfg_sched["gamma"] ** (epoch // cfg_sched["step_size"])

        return fn

    if kind == "cosine":
        eta_min = cfg_sched["eta_min"]

        def fn(step):
            frac = min(1.0, (step // spe) / max(1, epochs))
            return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * frac))

        return fn

    if kind == "cosine_warm_restarts":
        t0 = float(cfg_sched["T_0"])
        tmult = float(max(1, cfg_sched.get("T_mult", 1)))
        eta_min = cfg_sched["eta_min"]

        def fn(step):
            # restart period measured in epochs, advanced per optimizer step
            e = step / spe
            if tmult == 1.0:
                start, t_i = math.floor(e / t0) * t0, t0
            else:
                # closed form: n completed restarts with geometric periods
                n = math.floor(math.log(e / t0 * (tmult - 1.0) + 1.0) / math.log(tmult))
                start = t0 * (tmult**n - 1.0) / (tmult - 1.0)
                t_i = t0 * tmult**n
            frac = (e - start) / t_i
            return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * frac))

        return fn

    if kind == "cosine_warmup":
        total = max(1, (steps_per_epoch * epochs) // max(1, grad_accum))
        warm = cfg_sched["warmup_steps"]
        eta_min = cfg_sched["eta_min"]
        ratio = eta_min / max(1e-12, base_lr)

        def fn(step):
            if step < warm:
                return base_lr * step / max(1, warm)
            prog = (step - warm) / max(1, total - warm)
            cosine = 0.5 * (1.0 + math.cos(math.pi * prog))
            return base_lr * (ratio + (1 - ratio) * cosine)

        return fn

    if kind == "onecycle":
        return cosine_onecycle_schedule(epochs * steps_per_epoch, base_lr, cfg_sched["pct_start"],
                                        cfg_sched["div_factor"], cfg_sched["final_div_factor"])

    raise ValueError(f"Unknown scheduler type: {kind}")


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule: a cosine from peak/div_factor up to
    peak over pct_start of the steps, then down to
    peak/(div_factor*final_div_factor), constant after."""
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive `transition_steps`")
    scales = {int(pct_start * transition_steps): div_factor,
              int(transition_steps): 1.0 / (div_factor * final_div_factor)}
    bounds = [0] + sorted(scales)
    values = np.cumprod([peak_value / div_factor] + [scales[b] for b in sorted(scales)]).tolist()

    def fn(count):
        for lo, hi, v0, v1 in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= count < hi:
                return v1 + (v0 - v1) / 2.0 * (math.cos(math.pi * (count - lo) / (hi - lo)) + 1)
        return values[-1] if count >= bounds[-1] else 0.0

    return fn


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam's defaults, which the JAX package takes


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """adam or adamw as the JAX package chains them (module docstring).

    ``frozen``: parameter-name prefixes the optimizer passes through
    untouched, their update being their gradient (optax.masked).
    """

    kind: str
    schedule: Callable[[int], float] | float
    weight_decay: float = 0.0
    clip_norm: float = 0.0
    accum: int = 1
    frozen: tuple[str, ...] = ()

    def _live(self, names) -> list[str]:
        return [k for k in names if not k.startswith(self.frozen)] if self.frozen else list(names)

    def init(self, params: dict) -> dict:
        live = self._live(params)
        state = {"count": 0,
                 "mu": {k: torch.zeros_like(params[k]) for k in live},
                 "nu": {k: torch.zeros_like(params[k]) for k in live}}
        if self.accum > 1:
            state["mini_step"] = 0
            state["acc"] = {k: torch.zeros_like(params[k]) for k in live}
        return state

    def lr(self, count: int) -> float:
        return self.schedule(count) if callable(self.schedule) else self.schedule

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        live = self._live(grads)
        g = {k: grads[k] for k in live}
        updates = {k: v for k, v in grads.items() if k not in g}
        if self.accum > 1:
            n = state["mini_step"]
            acc = {k: state["acc"][k] + (g[k] - state["acc"][k]) / (n + 1) for k in live}
            if n < self.accum - 1:
                updates.update({k: torch.zeros_like(g[k]) for k in live})
                return updates, {**state, "mini_step": n + 1, "acc": acc}
            g = acc
            state = {**state, "mini_step": 0, "acc": {k: torch.zeros_like(v) for k, v in acc.items()}}

        if self.clip_norm:
            norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
            keep = norm < self.clip_norm
            g = {k: torch.where(keep, v, (v / norm) * self.clip_norm) for k, v in g.items()}
        wd = self.weight_decay
        if self.kind == "adam" and wd:
            g = {k: v + wd * params[k] for k, v in g.items()}
        count = state["count"] + 1
        mu = {k: (1 - B1) * v + B1 * state["mu"][k] for k, v in g.items()}
        nu = {k: (1 - B2) * (v * v) + B2 * state["nu"][k] for k, v in g.items()}
        bc1, bc2 = _bias_correction(B1, count), _bias_correction(B2, count)
        u = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS) for k in live}
        if self.kind == "adamw" and wd:
            u = {k: v + wd * params[k] for k, v in u.items()}
        step = -self.lr(state["count"])
        updates.update({k: step * v for k, v in u.items()})
        return updates, {**state, "count": count, "mu": mu, "nu": nu}


def masked(tx: Optimizer, frozen: tuple[str, ...]) -> Optimizer:
    """``tx`` with the parameters under the name prefixes ``frozen`` passed
    through (optax.masked with those leaves False)."""
    return dataclasses.replace(tx, frozen=tuple(tx.frozen) + tuple(frozen))


def build_optimizer(cfg_opt, cfg_sched, cfg_train, steps_per_epoch: int) -> Optimizer:
    """adam/adamw with the configured LR schedule, plus grad accumulation."""
    accum = cfg_train.get("gradient_accumulation_steps", 1)
    sched = _schedule(cfg_sched, cfg_train, cfg_opt["lr"], steps_per_epoch, accum)
    kind = cfg_opt.get("type", "adam")
    if kind not in ("adam", "adamw"):
        raise ValueError(f"Unknown optimizer type: {kind}")
    # global-norm clip ahead of the moments; 0 turns it off (the JAX
    # package's optim.py:100-107 says why it defaults to 1.0)
    return Optimizer(kind=kind, schedule=sched, weight_decay=cfg_opt.get("weight_decay", 0.0),
                     clip_norm=float(cfg_opt.get("clip_norm", 1.0)), accum=max(1, accum))


@dataclasses.dataclass
class TrainState:
    """Parameters, optimizer state and the count of steps taken (flax's
    TrainState). ``apply_gradients`` returns a new state."""

    params: dict
    opt_state: dict
    tx: Optimizer
    step: int = 0

    @classmethod
    def create(cls, params: dict, tx: Optimizer) -> "TrainState":
        return cls(params=params, opt_state=tx.init(params), tx=tx)

    def apply_gradients(self, grads: dict) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        params = {k: p + updates[k] for k, p in self.params.items()}
        return dataclasses.replace(self, params=params, opt_state=opt_state, step=self.step + 1)
