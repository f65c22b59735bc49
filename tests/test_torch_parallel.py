"""Port parity for multi-GPU training and eval (parallel/, the train steps'
all-reduce, ShardedDeviceData, Trainer(mesh=), rollout_routes(mesh=),
dryrun.py) on gloo: the counterpart of tests/test_parallel.py and
tests/test_device_data.py's sharded cases.

One 2-rank and one 4-rank job (tests/test_torch_parallel_ranks.py) run every
check once per module; the tests read their results:

* the sharded step (each rank its 8 of 16 rows, one all-reduce) against
  JAX's single-device step: loss at rtol 2e-4, gradients at rtol 1e-3,
  atol 1e-4 (tests/test_parallel.py:56,67), parameters bitwise replicated;
* ``shard_batch`` padding (test_parallel.py:71), ``maybe_init_distributed``
  a no-op without torchrun's variables (:79), the multislice psum over a
  2 x 2 mesh (:87);
* ``ShardedDeviceData`` at data=2 and 4: each rank's frames, gaze,
  actions, windows and ``n_local``, and ``epoch_perm``, bitwise JAX's
  (test_device_data.py:66);
* a sharded device-resident Trainer whose parameters stay bitwise
  replicated (test_device_data.py:46), and a resumed 2-rank run bitwise
  equal to the whole one on both data paths;
* the sharded eval: every rank's states and trace bitwise those of
  single-process rollouts of each rank's worlds at the same batch, on the
  same rows of ``env_draws(split(key, n))``; an uneven split raises;
* ``dryrun_multichip(2, "cpu")``.
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as R
from gabril_carla_tpu.data import BCDataset as JBCDataset
from gabril_carla_tpu.data import synthetic_episodes as j_synthetic_episodes
from gabril_carla_tpu.data.dataset import EpisodeStore as JEpisodeStore
from gabril_carla_tpu.parallel import make_mesh as j_make_mesh
from gabril_carla_tpu.train import init_bc_state as j_init_bc_state
from gabril_carla_tpu.train.bc import bc_loss_fn as j_bc_loss_fn
from gabril_carla_tpu.train.device_data import ShardedDeviceData as JShardedDeviceData
from gabril_carla_tpu.train.optim import build_optimizer as j_build_optimizer
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.env.world import load_benchmark_specs, spec_rows, to_torch
from gabril_carla_tpu_torch.parallel import maybe_init_distributed
from gabril_carla_tpu_torch.parallel.mesh import tree_leaves
from gabril_carla_tpu_torch.utils.prng import env_draws, prng_key, split
from test_parallel import small_cfg
from test_torch_common import cpu_threads

EPISODE_LENGTHS = (11, 7, 13, 5, 9, 6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


@functools.lru_cache(maxsize=None)
def jax_step():
    """JAX's single-device gradients and loss on tests/test_parallel.py's
    batch, and the port's starting parameters converted from JAX's."""
    cfg = small_cfg()
    store = j_synthetic_episodes(n_demos=2, steps=16, img_hw=(24, 48), max_points=3)
    batch = JBCDataset(store, frame_stack=2).sample(np.arange(16))
    tx = j_build_optimizer(cfg.optimizer, cfg.scheduler, cfg.training, steps_per_epoch=2)
    models, state = j_init_bc_state(cfg, jax.random.PRNGKey(0), tx)
    rng = jax.random.PRNGKey(7)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_bc_loss_fn(p, models, cfg, b, rng), has_aux=True))(state.params, batch)
    pcfg = R.step_cfg()
    params = convert.params_from_flax(jax.tree.map(np.asarray, state.params), pcfg)
    grads = convert.params_from_flax(jax.tree.map(np.asarray, grads), pcfg)
    return batch, params, float(loss), grads


@functools.lru_cache(maxsize=None)
def episodes():
    """RGB episodes of unequal lengths, so the greedy assignment matters."""
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 256, (n, 24, 48, 3), dtype=np.uint8),
             rng.random((n, 6), dtype=np.float32), rng.random((n, 7), dtype=np.float32))
            for n in EPISODE_LENGTHS]


def write_inputs(tmp):
    batch, params, _, _ = jax_step()
    torch.save({"batch": batch, "params": params, "episodes": episodes()}, tmp / "inputs.pt")


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo2")
    write_inputs(tmp)
    return R.spawn(R.two_ranks, 2, tmp)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo4")
    write_inputs(tmp)
    return R.spawn(R.four_ranks, 4, tmp)


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_sharded_step_matches_single_device(two):
    _, _, loss, grads = jax_step()
    for r in two:
        np.testing.assert_allclose(r["step"]["loss"], loss, rtol=2e-4)
        assert r["step"]["step_loss"] == r["step"]["loss"]
        assert set(r["step"]["grads"]) == set(grads)
        for k, g in grads.items():
            assert np.allclose(r["step"]["grads"][k].numpy(), g.numpy(), rtol=1e-3, atol=1e-4), k
    assert_trees_equal(two[0]["step"]["grads"], two[1]["step"]["grads"])
    assert_trees_equal(two[0]["step"]["params"], two[1]["step"]["params"])


def test_shard_batch_pads_ragged(two):
    rows = np.concatenate([r["shard"][:, 0] for r in two])
    np.testing.assert_array_equal(rows, [0, 1, 2, 3, 4, 4])  # padded to a multiple of 2


def test_maybe_init_distributed_noop_without_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GABRIL_RANK", "1")  # read by nothing
    assert maybe_init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()


def test_multislice_mesh_psum(four):
    for r in four:
        assert r["mesh_shape"] == (2, 2)
        assert r["psum"] == 4.0


def jax_sharded(n):
    store = JEpisodeStore()
    for img, gaze, act in episodes():
        store.add(img, gaze, act)
    mesh = j_make_mesh(jax.devices()[:n], data=n, model=1)
    sdd = JShardedDeviceData(store, frame_stack=2, mesh=mesh, grayscale_store=True)
    arrays = {k: np.asarray(v) for k, v in sdd.arrays().items()}
    return sdd, arrays, sdd.epoch_perm(np.random.default_rng(0), R.PERM_STEPS, R.PERM_BS)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_device_data_matches_jax(two, four, n):
    sdd, arrays, perm = jax_sharded(n)
    ranks = two if n == 2 else four
    for d, r in enumerate(ranks):
        got = r["sharded_data"]
        assert got["rank"] == d
        np.testing.assert_array_equal(got["n_local"], sdd.n_local)
        np.testing.assert_array_equal(got["perm"], perm)
        m = int(sdd.n_local[d])
        for k, v in arrays.items():
            assert got[k].shape[0] == m, k
            np.testing.assert_array_equal(got[k], v[d, :m].astype(got[k].dtype), err_msg=k)
            assert not v[d, m:].any(), k  # JAX pads its shards with zeros
    assert sum(int(x) for x in sdd.n_local) == sum(EPISODE_LENGTHS)


def test_sharded_trainer_replicates(two):
    assert all(r["trainer"]["sharded"] for r in two)
    assert np.isfinite(two[0]["trainer"]["loss"]) and two[0]["trainer"]["loss"] == two[1]["trainer"]["loss"]
    assert_trees_equal(two[0]["trainer"]["params"], two[1]["trainer"]["params"])
    # only the first rank wrote: one metrics line an epoch, one checkpoint
    from pathlib import Path

    run = Path(two[0]["trainer"]["ckpt_dir"]).parent
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 3
    assert json.loads((run / "checkpoints" / "params.json").read_text())


@pytest.mark.parametrize("device_data", [True, False], ids=["sharded_device", "host_batches"])
def test_resumed_run_equals_whole(two, device_data):
    for r in two:
        (pw, ow, sw), (pr, orr, sr) = r["resume"][device_data]
        assert sw == sr == 3 * R.RESUME_DEMOS * R.RESUME_STEPS // 8  # 3 epochs at batch 8
        assert_trees_equal(pw, pr)
        assert_trees_equal(ow, orr)
    assert_trees_equal(two[0]["resume"][device_data][0][0], two[1]["resume"][device_data][0][0])


def test_sharded_eval_matches_per_rank_rollouts(two):
    specs = load_benchmark_specs(R.EVAL_ROUTES)
    n = len(R.EVAL_ROUTES)
    draws = env_draws(split(prng_key(R.EVAL_KEY), n), R.EVAL_TICKS)
    fn, params = R.eval_policy()
    states, traces = [], []
    for rows in (np.arange(0, n // 2), np.arange(n // 2, n)):  # each rank's worlds
        st, tr = fn(to_torch(spec_rows(specs, rows), "cpu"), params,
                    draws=torch.from_numpy(draws[:, rows]))
        states.append(st)
        traces.append(tr)
    want_trace = torch.cat(traces, 1)
    assert float((want_trace[-1] - want_trace[0]).norm(dim=-1).max()) > 0.2  # the worlds drove
    for r in two:
        st, trace = r["eval"]
        assert torch.equal(trace, want_trace)
        for f in dataclasses.fields(st):
            want = [getattr(s, f.name) for s in states]
            got = getattr(st, f.name)
            if isinstance(got, torch.Tensor):
                assert torch.equal(got, torch.cat(want)), f.name
            else:
                assert_trees_equal(got, dataclasses.replace(
                    want[0], **{g.name: torch.cat([getattr(w, g.name) for w in want])
                                for g in dataclasses.fields(want[0])}))


def test_sharded_eval_needs_even_split(two):
    assert all("do not split" in r["eval_uneven"] for r in two)


def test_dryrun_multichip_cpu():
    from gabril_carla_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(2, "cpu")
    assert out["ranks"] == 2 and len(out["eval_scores"]) == 2
    assert out["step_replicated"] and out["epoch_replicated"] and out["full_replicated"]
    assert np.isfinite([out["step_loss"], out["epoch_loss"], out["full_loss"]]).all()


def test_torchrun_train_bc_cpu(tmp_path):
    """``torchrun --nproc_per_node 2`` on cli/train_bc.py (gloo: the CLI
    takes device="cpu" from the caller): both ranks join through
    maybe_init_distributed, train sharded, and only the first writes."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    tiny = ["data.img_height=24", "data.img_width=48", "model.embedding_dim=8", "model.num_hiddens=16",
            "model.num_residual_layers=1", "model.num_residual_hiddens=8", "model.z_dim=16",
            "training.epochs=2", "training.compute_dtype=float32", "data.batch_size=16",
            f"logging.log_dir={tmp_path / 'runs'}", "logging.run_name=tr", "data.task=T"]
    code = ("import sys; from gabril_carla_tpu_torch.cli import train_bc; "
            "sys.exit(train_bc.main(sys.argv[1:], device='cpu'))")
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo)}
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", "--no-python", sys.executable, "-c", code, *tiny],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "rank 1/2 (gloo" in out.stdout
    run = tmp_path / "runs" / "T" / "tr"
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 2
    assert (run / "checkpoints" / "ep2" / "params.pt").exists()
