"""The reference's first train steps and the numbers that judge a train step.

``follow(kind, cfg, params0, batches, steps_per_epoch)`` runs the plain
float32 step (models.py) from the benchmark's initial parameters over the
given batches and returns what the port's step is held to: each step's
loss, the first gradient as the optimizer gets it (worked out from Adam's
first moment after one step, ``mu / (1 - b1)``: clipped, with decay added)
and each leaf's change over the steps. ``fmt`` computes every product in a
lower precision (lowering.py); ``fault`` plants one of the faults the check
has to catch.

``train_numbers(prog, ref)`` gives the numbers a cell's limits pick from:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: over leaves, the gap between the two sides' norms of the
  first gradient, over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
* ``change_gap``: the same for the norm of each leaf's change over the
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a leaf whose gradient is nought to rounding, as a
  conv bias under a GroupNorm of its own channel, moves under Adam by
  round-off alone);
* ``change_med``: the median of those leaves' change gaps, which half a
  batch left out moves on every leaf and rounding on a few.
"""

from __future__ import annotations

import contextlib

import torch

from . import models
from .frozen.train.optim import B1
from .lowering import Lowered

FAULTS = ("half_batch", "altered_grad")
NULL_GRAD = 1e-3  # of the median leaf's gradient norm


def altered_leaf(grads: dict) -> str:
    """The leaf whose gradient the fault "altered_grad" doubles: the
    largest."""
    return max(grads, key=lambda k: (grads[k].numel(), k))


def _half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def follow(kind: str, cfg, params0: dict, batches: list, steps_per_epoch: int,
           fmt: str | None = None, fault: str | None = None) -> dict:
    """Run len(batches) reference steps from ``params0`` (float32, not
    changed). Returns {"loss": [floats], "grad": {leaf: norm}, "change":
    {leaf: norm}}."""
    models.f32_only()
    dev = next(iter(params0.values())).device
    model = (models.Policy(cfg) if kind == "bc" else models.gaze_model(cfg)).to(dev)
    loss_fn = models.bc_loss if kind == "bc" else models.gaze_loss
    tx = models.optimizer(cfg, steps_per_epoch)
    params = {k: v.detach().float().clone() for k, v in params0.items()}
    opt = tx.init(params)
    out = {"loss": []}
    low = (lambda: Lowered(fmt)) if fmt else contextlib.nullcontext
    for i, batch in enumerate(batches):
        if fault == "half_batch":
            batch = _half(batch)
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        with low():
            loss = loss_fn(model, cfg, live, batch)
            grads = torch.autograd.grad(loss, list(live.values()))
        grads = dict(zip(live, grads))
        if fault == "altered_grad":
            name = altered_leaf(grads)
            grads[name] = 2.0 * grads[name]
        updates, opt = tx.update(grads, opt, params)
        params = {k: p + updates[k] for k, p in params.items()}
        out["loss"].append(float(loss.detach()))
        if i == 0:
            out["grad"] = {k: float(torch.linalg.vector_norm(m / (1.0 - B1))) for k, m in opt["mu"].items()}
    out["change"] = {k: float(torch.linalg.vector_norm(params[k] - params0[k].float())) for k in params}
    return out


def program_readings(losses, mu_after_one: dict, params_after: dict, params0: dict) -> dict:
    """The port's side in the same form: its losses, its first gradient from
    its optimizer's first moment after step one, its leaves' change."""
    return {"loss": [float(x) for x in losses],
            "grad": {k: float(torch.linalg.vector_norm(m.float() / (1.0 - B1)))
                     for k, m in mu_after_one.items()},
            "change": {k: float(torch.linalg.vector_norm(params_after[k].float() - params0[k].float()))
                       for k in params0}}


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])


def _worst(gaps) -> float:
    """The largest gap; a non-finite one reads infinite."""
    return max((g if g == g and g != float("inf") else float("inf")) for g in gaps)


def _leaf_gap(prog: dict, ref: dict, leaves) -> float:
    med = _median([ref[k] for k in leaves])
    return _worst(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def train_numbers(prog: dict, ref: dict) -> dict:
    """The numbers (module docstring) of the port's readings against the
    reference's."""
    loss = _worst(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("inf")
    leaves = sorted(ref["grad"])
    grad = _leaf_gap(prog["grad"], ref["grad"], leaves)
    med = _median([ref["grad"][k] for k in leaves])
    moving = [k for k in leaves if ref["grad"][k] >= NULL_GRAD * med]
    change = _leaf_gap(prog["change"], ref["change"], moving)
    cmed = _median([ref["change"][k] for k in moving])
    change_med = _median([abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], cmed, 1e-30)
                          for k in moving])
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "change_med": change_med if change_med == change_med else float("inf")}
