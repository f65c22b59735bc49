"""The rank side of tests/test_torch_parallel.py: gloo jobs of 2 and 4 CPU
processes that run every multi-rank check of the port once and save each
rank's results to the job's directory (``rank<r>.pt``). It holds no tests
and imports no JAX: the ranks are spawned processes, and the JAX side of
each comparison runs in the test process.

A job joins its ranks through a file rendezvous in its own directory (no
TCP port, so parallel test workers cannot collide) and runs each rank on
one torch thread.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gabril_carla_tpu_torch.data.dataset import BCDataset, EpisodeStore, synthetic_episodes
from gabril_carla_tpu_torch.env.world import load_benchmark_specs
from gabril_carla_tpu_torch.eval.rollout import make_rollout_fn, rollout_routes
from gabril_carla_tpu_torch.parallel import make_mesh, make_multislice_mesh, pmean, shard_batch
from gabril_carla_tpu_torch.parallel.mesh import data_group
from gabril_carla_tpu_torch.train.bc import (build_bc_models, init_bc_params, loss_and_grads,
                                             make_bc_policy_fn, make_bc_train_step)
from gabril_carla_tpu_torch.train.device_data import ShardedDeviceData
from gabril_carla_tpu_torch.train.loop import Trainer
from gabril_carla_tpu_torch.train.optim import TrainState, build_optimizer
from gabril_carla_tpu_torch.utils.config import default_bc_config
from gabril_carla_tpu_torch.utils.prng import prng_key

EVAL_ROUTES = [3100, 27494, 2416, 24211]  # seen routes: 4 worlds, 2 a rank
EVAL_TICKS, EVAL_KEY = 20, 9
PERM_STEPS, PERM_BS = 3, 4
RESUME_DEMOS, RESUME_STEPS = 4, 16  # 64 samples: 8 steps an epoch at batch 8


def spawn(job, world: int, tmp) -> list[dict]:
    """Run ``job(rank, world, tmp)`` on ``world`` gloo ranks; the ranks'
    results in rank order."""
    torch.multiprocessing.spawn(_rank, args=(job, world, str(tmp)), nprocs=world, join=True)
    return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank(rank, job, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv", rank=rank, world_size=world)
    try:
        torch.save(job(rank, world, tmp), Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def step_cfg():
    """tests/test_parallel.py small_cfg, in the port."""
    cfg = default_bc_config()
    cfg["data"].update(img_height=24, img_width=48, frame_stack=2, batch_size=16)
    cfg["model"].update(embedding_dim=8, num_hiddens=16, num_residual_layers=1,
                        num_residual_hiddens=8, z_dim=16)
    cfg["gaze"].update(method="None", max_points=3, mask_sigma=4.0)
    cfg["training"].update(compute_dtype="float32")
    cfg["scheduler"]["type"] = "none"
    return cfg


def trainer_cfg(device_data: bool, log_dir, run_name: str, epochs: int):
    """tests/test_device_data.py cfg_small, in the port."""
    cfg = default_bc_config()
    cfg["data"].update(img_height=24, img_width=48, frame_stack=2, batch_size=8)
    cfg["model"].update(embedding_dim=8, num_hiddens=16, num_residual_layers=1,
                        num_residual_hiddens=8, z_dim=16)
    cfg["gaze"].update(method="Reg", max_points=3, mask_sigma=4.0)
    cfg["training"].update(epochs=epochs, compute_dtype="float32", save_interval=99,
                           device_data=device_data)
    cfg["scheduler"]["type"] = "none"
    cfg["logging"].update(log_dir=str(log_dir), run_name=run_name)
    return cfg


def eval_cfg():
    """tests/test_torch_rollout.py small_cfg."""
    cfg = default_bc_config()
    cfg["gaze"]["method"] = "None"
    cfg["training"]["compute_dtype"] = "float32"
    cfg["model"].update(num_hiddens=8, embedding_dim=8, z_dim=16, num_residual_hiddens=4)
    return cfg


def eval_policy():
    """(rollout fn, params): the small policy from seed 0, throttle biased
    so the worlds drive."""
    cfg = eval_cfg()
    models = build_bc_models(cfg, device="cpu")
    params = init_bc_params(models, cfg, torch.Generator().manual_seed(0))
    params["actor.fc2.bias"][0] = 0.6
    return make_rollout_fn(make_bc_policy_fn(models, cfg), cfg, steps=EVAL_TICKS), params


def episode_store(episodes) -> EpisodeStore:
    store = EpisodeStore()
    for img, gaze, act in episodes:
        store.add(img, gaze, act)
    return store


def sharded_data(mesh, episodes) -> dict:
    sdd = ShardedDeviceData(episode_store(episodes), 2, mesh, grayscale_store=True, device="cpu")
    out = {k: v.numpy() for k, v in sdd.arrays().items()}
    out.update(n_local=sdd.n_local, rank=sdd.rank,
               perm=sdd.epoch_perm(np.random.default_rng(0), PERM_STEPS, PERM_BS))
    return out


def run_trainer(device_data: bool, log_dir, run_name: str, epochs: int, mesh, resume=False,
                n_demos=10, steps=24):
    store = synthetic_episodes(n_demos=n_demos, steps=steps, img_hw=(24, 48), max_points=3)
    tr = Trainer(trainer_cfg(device_data, log_dir, run_name, epochs), BCDataset(store, frame_stack=2),
                 mode="bc", device="cpu", mesh=mesh)
    metrics = tr.train(resume=resume)
    return tr, metrics


def two_ranks(rank, world, tmp) -> dict:
    """Every 2-rank check: the sharded step, shard_batch, ShardedDeviceData
    at data=2, a sharded Trainer, resume in both data paths, the sharded
    eval."""
    inp = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
    mesh = make_mesh(device="cpu")
    group = data_group(mesh)
    out = {}

    cfg = step_cfg()
    models = build_bc_models(cfg, device="cpu")
    state = TrainState.create({k: v.clone() for k, v in inp["params"].items()},
                              build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, 2))
    local = {k: torch.from_numpy(v) for k, v in shard_batch(inp["batch"], mesh).items()}
    _, metrics, grads = loss_and_grads(models, cfg, state.params, local, None)
    grads, metrics = pmean((grads, metrics), group)
    new, step_metrics = make_bc_train_step(models, cfg, group)(state, local, None)
    out["step"] = {"loss": float(metrics["loss"]), "grads": grads,
                   "step_loss": float(step_metrics["loss"]), "params": new.params}

    out["shard"] = shard_batch({"x": np.arange(5, dtype=np.float32)[:, None]}, mesh)["x"]
    out["sharded_data"] = sharded_data(mesh, inp["episodes"])

    tr, m = run_trainer(True, Path(tmp) / "runs", "sharded", 3, mesh)
    out["trainer"] = {"loss": m["loss"], "params": tr.state.params,
                      "sharded": tr.device_mode and tr._sharded_device,
                      "ckpt_dir": str(tr.logger.ckpt_dir)}

    out["resume"] = {}
    small = {"n_demos": RESUME_DEMOS, "steps": RESUME_STEPS}
    for dd in (True, False):
        whole, _ = run_trainer(dd, Path(tmp) / "runs", f"whole_{dd}", 3, mesh, **small)
        run_trainer(dd, Path(tmp) / "runs", f"resumed_{dd}", 2, mesh, resume=True, **small)
        resumed, _ = run_trainer(dd, Path(tmp) / "runs", f"resumed_{dd}", 3, mesh, resume=True,
                                 **small)
        out["resume"][dd] = [(t.state.params, t.state.opt_state, t.state.step) for t in (whole, resumed)]

    fn, params = eval_policy()
    specs = load_benchmark_specs(EVAL_ROUTES)
    st, trace = rollout_routes(specs, params, fn, prng_key(EVAL_KEY), device="cpu", mesh=mesh)
    out["eval"] = (st, trace)
    try:
        rollout_routes(load_benchmark_specs(EVAL_ROUTES[:3]), params, fn, prng_key(EVAL_KEY),
                       device="cpu", mesh=mesh)
    except ValueError as e:
        out["eval_uneven"] = str(e)
    return out


def four_ranks(rank, world, tmp) -> dict:
    """The multislice psum over a 2 x 2 mesh and ShardedDeviceData at data=4."""
    inp = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
    mesh = make_multislice_mesh(model=2, device="cpu")
    x = torch.ones(1)
    dist.all_reduce(x, group=mesh.get_group(0))
    dist.all_reduce(x, group=mesh.get_group(1))
    return {"mesh_shape": tuple(mesh.shape), "psum": float(x[0]),
            "sharded_data": sharded_data(make_mesh(4, 1, "cpu"), inp["episodes"])}
