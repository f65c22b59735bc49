"""Entry points for a quick check of the port: the BC policy's forward at
full size, and a data-parallel dry run over n ranks (port of the JAX
package's __graft_entry__.py).

    python -c "from gabril_carla_tpu_torch.dryrun import dryrun_multichip; dryrun_multichip(2, 'cpu')"

``dryrun_multichip(n, device)`` runs four legs on a ('data', 'model') mesh
of n ranks: one sharded BC step at toy size, one sharded device-resident
epoch, a sharded closed-loop eval through ``rollout_routes(mesh=)``, and
two steps at the real geometry (180x320, default widths, bf16, batch 2 a
rank). Each leg must end finite, and every train leg with its parameters
bitwise equal on every rank. With ``device="cuda"`` it needs n cards; with
``"cpu"`` it spawns n gloo processes (the JAX package provisions n virtual
CPU devices instead). Inside an open process group of n ranks it runs in
the calling processes.
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _full_cfg():
    from .utils.config import default_bc_config

    cfg = default_bc_config()
    cfg["gaze"]["method"] = "Reg"
    cfg["training"]["compute_dtype"] = "bfloat16"
    return cfg


def _toy(cfg):
    cfg["model"].update(embedding_dim=8, num_hiddens=16, num_residual_layers=1,
                        num_residual_hiddens=8, z_dim=16)
    cfg["training"]["compute_dtype"] = "float32"
    return cfg


def entry(device="cuda"):
    """(fn, example_args): the BC policy's forward at full size (Reg, bf16)
    on ``device``, with a zero batch of 8 observations."""
    from .train.bc import build_bc_models, init_bc_params, make_bc_policy_fn

    cfg = _full_cfg()
    models = build_bc_models(cfg, device)
    params = init_bc_params(models, cfg, torch.Generator(device=device).manual_seed(0))
    obs = torch.zeros((8, cfg.data["img_height"], cfg.data["img_width"], cfg.data["frame_stack"]),
                      device=device)
    return make_bc_policy_fn(models, cfg), (params, obs)


def _replicated(params: dict, group) -> bool:
    """Whether every rank of ``group`` holds bitwise the same parameters."""
    flat = torch.cat([v.detach().reshape(-1).float() for v in params.values()])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def _legs(n: int, device) -> dict:
    """The four legs on this rank; returns their numbers."""
    from .data.dataset import BCDataset, synthetic_episodes
    from .env.criteria import compute_score
    from .env.world import build_world_spec, stack_specs, to_torch
    from .eval.rollout import make_rollout_fn, rollout_routes
    from .parallel.mesh import broadcast_state, data_group, make_mesh, shard_batch
    from .train.bc import (build_bc_models, init_bc_params, init_bc_state, make_bc_policy_fn,
                           make_bc_train_step)
    from .train.device_data import ShardedDeviceData, make_sharded_epoch_fn
    from .train.optim import build_optimizer
    from .utils.prng import prng_key

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def on_device(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def report(msg):
        if dist.get_rank() == 0:
            print(f"dryrun_multichip({n}): {msg}", flush=True)

    mesh = make_mesh(n, 1, device)
    group = data_group(mesh)
    out = {"ranks": n, "device": str(device)}

    # 1. one sharded step at toy size: each rank its rows, one all-reduce
    t0 = time.perf_counter()
    cfg = _toy(_full_cfg())
    cfg["data"].update(img_height=24, img_width=48, batch_size=2 * n, frame_stack=2)
    cfg["gaze"].update(max_points=3, mask_sigma=4.0)
    cfg["scheduler"]["type"] = "none"
    tx = build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=2)
    models, state = init_bc_state(cfg, gen(0), tx, device)
    broadcast_state(state, mesh)
    step = make_bc_train_step(models, cfg, group)
    store = synthetic_episodes(n_demos=1, steps=max(16, 2 * n), img_hw=(24, 48), max_points=3)
    batch = shard_batch(BCDataset(store, frame_stack=2).sample(np.arange(2 * n)), mesh)
    state, metrics = step(state, on_device(batch), gen(1))
    out["step_loss"] = float(metrics["loss"])
    out["step_replicated"] = _replicated(state.params, group)
    out["step_s"] = time.perf_counter() - t0
    report(f"sharded step loss={out['step_loss']:.4f}, replicated {out['step_replicated']}")

    # 2. a sharded device-resident epoch: whole episodes per rank
    t0 = time.perf_counter()
    store2 = synthetic_episodes(n_demos=2 * n, steps=12, img_hw=(24, 48), max_points=3)
    sdd = ShardedDeviceData(store2, frame_stack=2, mesh=mesh, grayscale_store=True, device=device)
    epoch_fn = make_sharded_epoch_fn(sdd, step, steps_per_epoch=2, local_bs=2)
    perm = sdd.epoch_perm(np.random.default_rng(0), steps_per_epoch=2, local_bs=2)
    state, em = epoch_fn(state, perm, prng_key(2))
    out["epoch_loss"] = float(em["loss"])
    out["epoch_replicated"] = _replicated(state.params, group)
    out["epoch_s"] = time.perf_counter() - t0
    report(f"sharded device-resident epoch loss={out['epoch_loss']:.4f}, "
           f"replicated {out['epoch_replicated']}")

    # 3. a sharded closed-loop eval: n straight routes, one a rank
    t0 = time.perf_counter()
    ecfg = _toy(_full_cfg())
    ecfg["gaze"]["method"] = "None"
    emodels = build_bc_models(ecfg, device)
    eparams = init_bc_params(emodels, ecfg, gen(3))
    roll = make_rollout_fn(make_bc_policy_fn(emodels, ecfg), ecfg, steps=3)
    wps = np.stack([np.arange(0.0, 120, 2.0), np.zeros(60)], 1).astype(np.float32)
    specs = stack_specs([build_world_spec({"id": i, "town": "T", "waypoints": wps + i,
                                           "scenarios": [], "weather": [0, 0, 0, 90]})
                         for i in range(n)])
    states, _ = rollout_routes(specs, eparams, roll, prng_key(4), device=device, mesh=mesh)
    scores = compute_score(to_torch(specs, device), states)["score_composed"]
    out["eval_scores"] = scores.tolist()
    out["eval_s"] = time.perf_counter() - t0
    report(f"sharded eval, {n} routes, score[0]={out['eval_scores'][0]:.1f}")

    # 4. the real geometry: 180x320, default widths, bf16, batch 2 a rank, 2 steps
    t0 = time.perf_counter()
    fcfg = _full_cfg()
    fcfg["data"]["batch_size"] = 2 * n
    fcfg["scheduler"]["type"] = "none"
    ftx = build_optimizer(fcfg.optimizer, fcfg.scheduler, fcfg.training, steps_per_epoch=2)
    fmodels, fstate = init_bc_state(fcfg, gen(5), ftx, device)
    broadcast_state(fstate, mesh)
    fstep = make_bc_train_step(fmodels, fcfg, group)
    fstore = synthetic_episodes(n_demos=1, steps=max(16, 2 * n),
                                img_hw=(fcfg.data["img_height"], fcfg.data["img_width"]),
                                max_points=fcfg.gaze["max_points"])
    fbatch = on_device(shard_batch(BCDataset(fstore, frame_stack=fcfg.data["frame_stack"]).sample(
        np.arange(2 * n)), mesh))
    for i in range(2):
        fstate, fmetrics = fstep(fstate, fbatch, gen(6 + i))
    out["full_loss"] = float(fmetrics["loss"])
    out["full_replicated"] = _replicated(fstate.params, group)
    out["full_s"] = time.perf_counter() - t0
    report(f"full-size leg (180x320, default widths, bs {2 * n}, bf16, 2 steps) "
           f"loss={out['full_loss']:.4f}, replicated {out['full_replicated']}")

    finite = [out["step_loss"], out["epoch_loss"], out["full_loss"], *out["eval_scores"]]
    if not np.isfinite(finite).all():
        raise RuntimeError(f"dryrun_multichip({n}): non-finite result {finite}")
    if not (out["step_replicated"] and out["epoch_replicated"] and out["full_replicated"]):
        raise RuntimeError(f"dryrun_multichip({n}): parameters differ across ranks")
    return out


def _rank_main(rank: int, n: int, device: str, tmp: str):
    """One spawned rank: join the group through a file rendezvous, run the
    legs, and (rank 0) write their numbers to ``tmp``/legs.json."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv", rank=rank, world_size=n)
    try:
        out = _legs(n, device)
        if rank == 0:
            (Path(tmp) / "legs.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device="cuda") -> dict:
    """Run the four legs over n ranks (module docstring); returns the first
    rank's numbers. Raises if a leg fails, if ``device="cuda"`` has fewer
    than n cards, or if an open process group is not of n ranks."""
    if torch.device(device).type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n}, {device!r}): only "
                         f"{torch.cuda.device_count()} CUDA devices")
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"dryrun_multichip({n}): the open process group has "
                             f"{dist.get_world_size()} ranks")
        return _legs(n, device)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_rank_main, args=(n, str(device), tmp), nprocs=n, join=True)
        return json.loads((Path(tmp) / "legs.json").read_text())
