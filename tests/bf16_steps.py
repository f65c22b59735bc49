"""The anchor's first BC steps in bf16, the JAX package against the port.

A diagnostic script, not a test: ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/bf16_steps.py [STEPS] [BATCH] [METHOD...]`` from the repo root. For
each METHOD (ViSaRL, and Mask as the control, by default), it builds
default_bc_config() at the anchor's size (180x320 grayscale, frame stack
2, hiddens 128, z_dim 256, bf16) with no dropout, takes JAX's flax-keyed
init (``init_bc_params`` at PRNGKey(42)) into both
packages, and runs STEPS (20) steps of the anchor's optimizer (Adam, lr
5e-4, cosine warm-up over 500 steps; 721 steps an epoch, 30 epochs) on the
same synthetic batches of BATCH (8) samples through each package's
``make_bc_train_step`` on the CPU. Each step prints JAX's loss, the port's,
their relative gap, and the relative L2 gap of the encoder's first-conv
kernel (the one layer with ViSaRL's 2S input channels) and of the worst
parameter leaf, each as the gap of the summed updates since the init over
JAX's summed updates. bf16's unit roundoff is 2^-8 = 3.9e-3.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.training.train_state import TrainState as JaxTrainState

import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu.data import BCDataset, synthetic_episodes
from gabril_carla_tpu.train.optim import build_optimizer as jax_optimizer
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.train.optim import TrainState, build_optimizer
from test_torch_heat_full_size import full_size_cfgs

STEPS_PER_EPOCH, EPOCHS = 721, 30  # the anchor's 92,407 frames at batch 128, 30 epochs
FIRST_CONV = "encoder.down1.weight"


def configs(method: str):
    """(JAX config, port config) at the anchor's size in bf16, 30 epochs."""
    cfgs = full_size_cfgs(method, "bfloat16")
    for cfg in cfgs:
        cfg["training"]["epochs"] = EPOCHS
    return cfgs


def batches(n: int, size: int) -> list[dict]:
    store = synthetic_episodes(n_demos=2, steps=max(16, n * size // 2 + 4), img_hw=(180, 320),
                               max_points=5, action_dim=7, seed=11)
    it = BCDataset(store, frame_stack=2, use_native=False).iter_batches(size, np.random.default_rng(11))
    return [next(it) for _ in range(n)]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def run(method: str, data: list[dict]) -> list[tuple]:
    jcfg, pcfg = configs(method)
    models = JB.build_bc_models(jcfg)
    params0 = JB.init_bc_params(models, jcfg, jax.random.PRNGKey(42))
    jstate = JaxTrainState.create(apply_fn=None, params=params0,
                                  tx=jax_optimizer(jcfg.optimizer, jcfg.scheduler, jcfg.training,
                                                   STEPS_PER_EPOCH))
    jstep = JB.make_bc_train_step(models, jcfg, donate=False)
    pmodels = PB.build_bc_models(pcfg, device="cpu")
    init = convert.params_from_flax(jax.tree.map(np.asarray, params0), pcfg)
    pstate = TrainState.create({k: v.clone() for k, v in init.items()},
                               build_optimizer(pcfg.optimizer, pcfg.scheduler, pcfg.training,
                                               STEPS_PER_EPOCH))
    pstep = PB.make_bc_train_step(pmodels, pcfg)
    key = jax.random.PRNGKey(1)  # unused by a step without dropout or partial gaze
    rows = []
    for i, batch in enumerate(data):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), key)
        pstate, pm = pstep(pstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        jp = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params), pcfg)
        gaps = {k: rel(pstate.params[k] - init[k], jp[k] - init[k]) for k in init}
        worst = max(gaps, key=gaps.get)
        jl, pl = float(jm["loss"]), float(pm["loss"])
        rows.append((i + 1, jl, pl, abs(pl - jl) / abs(jl), gaps[FIRST_CONV], gaps[worst], worst))
        print(f"{method:6s} step {i + 1:2d}: loss JAX {jl:.6f} port {pl:.6f} rel {rows[-1][3]:.2e} | "
              f"first conv {gaps[FIRST_CONV]:.2e} | worst leaf {gaps[worst]:.2e} ({worst})", flush=True)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[0]) if argv else 20
    size = int(argv[1]) if len(argv) > 1 else 8
    methods = argv[2:] or ["ViSaRL", "Mask"]
    data = batches(steps, size)
    summary = {}
    for method in methods:
        t0 = time.time()
        summary[method] = run(method, data)
        print(f"{method}: {steps} steps in {time.time() - t0:.1f} s", flush=True)
    print("| Step | " + " | ".join(f"{m} loss gap | {m} first conv | {m} worst leaf" for m in methods) + " |")
    print("| --- " * (1 + 3 * len(methods)) + "|")
    for i in range(steps):
        if i + 1 in (1, 2, 5, 10, 15, 20) or i + 1 == steps:
            cells = [f"{r[3]:.2e} | {r[4]:.2e} | {r[5]:.2e}" for r in (summary[m][i] for m in methods)]
            print(f"| {i + 1} | " + " | ".join(cells) + " |")


if __name__ == "__main__":
    main()
