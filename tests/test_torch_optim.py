"""Port parity: the optimizer (train/optim.py) against the JAX package's
optax chain (gabril_carla_tpu.train.optim.build_optimizer), fed the same
gradients for 8 steps: every schedule, adam and adamw, L2 weight decay on
and off, the global-norm clip on and off (the gradient scales alternate so
it both fires and not), gradient accumulation 1 and 2, and Oreo's optimizer
mask. Updates agree at rtol 1e-5, with an atol of 1e-5 of the leaf's
largest update for the elements where Adam's ratio is small (float32 on both
sides; the schedules are float64 on the port's host, float32 in JAX;
measured at most 1.2e-5 relative, on an element 1% of its leaf's scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gabril_carla_tpu.train import optim as JO
from gabril_carla_tpu_torch.train import optim as PO

SPE, EPOCHS, STEPS, LR = 3, 4, 8, 1e-3
SHAPES = {"encoder": {"w": (3, 4), "b": (4,)}, "actor": {"k": (5, 2)}, "quantizer": {"codebook": (4, 3)}}
SCHEDULES = ["none", "step", "cosine", "cosine_warm_restarts", "cosine_warm_restarts_tmult2",
             "cosine_warmup", "onecycle"]


def configs(sched, kind="adam", wd=0.01, clip=1.0, accum=1):
    cfg_s = {"type": sched.replace("_tmult2", ""), "step_size": 2, "gamma": 0.5, "eta_min": 1e-5,
             "warmup_steps": 3, "T_0": 1, "T_mult": 2 if sched.endswith("tmult2") else 1,
             "pct_start": 0.3, "div_factor": 25.0, "final_div_factor": 1e4}
    cfg_t = {"epochs": EPOCHS, "gradient_accumulation_steps": accum}
    cfg_o = {"type": kind, "lr": LR, "weight_decay": wd, "clip_norm": clip}
    return cfg_o, cfg_s, cfg_t


def flat(tree) -> dict:
    return {f"{m}.{k}": v for m, leaves in tree.items() for k, v in leaves.items()}


def run_both(cfg_o, cfg_s, cfg_t, oreo_mask=False):
    rng = np.random.default_rng(0)
    params = {m: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaves.items()}
              for m, leaves in SHAPES.items()}
    grads = [{m: {k: (rng.standard_normal(s) * (0.05 if i % 2 else 0.8)).astype(np.float32)
                  for k, s in leaves.items()} for m, leaves in SHAPES.items()} for i in range(STEPS)]

    tx = JO.build_optimizer(cfg_o, cfg_s, cfg_t, SPE)
    ptx = PO.build_optimizer(cfg_o, cfg_s, cfg_t, SPE)
    if oreo_mask:  # as gabril_carla_tpu/train/bc.py:117-123 and port init_bc_state
        tx = optax.masked(tx, lambda p: {k: k != "quantizer" for k in p})
        ptx = PO.masked(ptx, ("quantizer.",))
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    pp = {k: torch.from_numpy(v) for k, v in flat(params).items()}
    ps = ptx.init(pp)
    for i, g in enumerate(grads):
        ju, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = ptx.update({k: torch.from_numpy(v) for k, v in flat(g).items()}, ps, pp)
        pp = {k: p + pu[k] for k, p in pp.items()}
        for k, want in flat(jax.tree.map(np.asarray, ju)).items():
            np.testing.assert_allclose(pu[k].numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"step {i} {k}")
    for k, want in flat(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(pp[k].numpy(), want, rtol=1e-5, err_msg=k)
    return pp


@pytest.mark.parametrize("kind", ["adam", "adamw"])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedules_match_optax(sched, kind):
    run_both(*configs(sched, kind))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_options_match_optax(kind, wd, clip, accum):
    run_both(*configs("cosine_warmup", kind, wd, clip, accum))


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_oreo_mask_matches_optax(kind):
    """The masked quantizer's update is its gradient, passed through (here
    nonzero; in training it is zero, so the codebook stays put)."""
    run_both(*configs("cosine", kind, wd=0.1, accum=2), oreo_mask=True)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedule_values_match(sched):
    cfg_o, cfg_s, cfg_t = configs(sched)
    want = JO._schedule(cfg_s, cfg_t, LR, SPE)
    got = PO._schedule(cfg_s, cfg_t, LR, SPE)
    counts = range(1, 3 * SPE * EPOCHS)  # past the end of the schedule too
    if not callable(want):
        assert got == want
        return
    np.testing.assert_allclose([got(c) for c in counts], [float(want(jnp.int32(c))) for c in counts],
                               rtol=1e-5, atol=1e-12)
