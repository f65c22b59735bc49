"""Port parity for the training draws, whole Trainers: a JAX Trainer and a
port Trainer of one seed (init, shuffles, step keys, dropout draws and
revives all their own, nothing injected), and the sharded epochs' keys at
2 gloo ranks. The draws themselves are held bitwise in
tests/test_torch_train_draws.py.

Bars: two epochs of a Trainer within
test_torch_trainer.py::test_epoch_matches_jax_epoch's bars (params atol
2e-5, metrics rtol 1e-5); the step keys and the sharded keys bitwise. The
VQ-VAE Trainer runs two steps an epoch: Adam divides a gradient by its own
magnitude plus 1e-8, so float32 noise in small gradients grows with the
steps (at three steps an epoch its decoder.up2 kernel reached 2.5e-5).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from gabril_carla_tpu.data import BCDataset as JDataset
from gabril_carla_tpu.data import synthetic_episodes as j_synthetic
from gabril_carla_tpu.parallel.mesh import make_mesh
from gabril_carla_tpu.train.loop import Trainer as JTrainer
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes
from gabril_carla_tpu_torch.train import vqvae as PV
from gabril_carla_tpu_torch.train.loop import Trainer
from test_torch_common import BC_A, BC_H, BC_P, BC_S, BC_W, bc_cfgs, cpu_threads
from test_torch_vqvae import cfgs as vq_cfgs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


# --- whole Trainers from one seed, nothing injected ------------------------------

EPISODES = dict(n_demos=2, steps=6, img_hw=(BC_H, BC_W), max_points=BC_P, action_dim=BC_A, seed=3)


def run_both(jcfg, pcfg, episodes, mode, tmp_path, frame_stack):
    for cfg in (jcfg, pcfg):
        cfg.set_path("logging.log_dir", str(tmp_path))
    # one JAX device, as the port's one process (conftest gives JAX eight)
    jt = JTrainer(jcfg, JDataset(j_synthetic(**episodes), frame_stack, use_native=False), mode=mode,
                  mesh=make_mesh(jax.devices()[:1]))
    jm = jt.train()
    pt = Trainer(pcfg, BCDataset(synthetic_episodes(**episodes), frame_stack), mode=mode, device="cpu")
    pm = pt.train()
    return jt, jm, pt, pm


def assert_trainers_agree(jt, jm, pt, pm, to_port):
    want = to_port(jax.tree.map(np.asarray, jt.state.params))
    assert set(want) == set(pt.state.params)
    for k, w in want.items():
        np.testing.assert_allclose(pt.state.params[k].numpy(), w.numpy(), atol=2e-5, rtol=0, err_msg=k)
    assert set(jm) == set(pm)
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k], float(v), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("device_data", [True, False])
@pytest.mark.parametrize("dropout", ["None", "GMD", "IGMD", "Oreo"])
def test_trainer_from_seed_matches_jax(tmp_path, dropout, device_data):
    """The fault closed: a JAX Trainer and a port Trainer of training.seed
    3 (init, shuffles, step keys, dropout draws all their own) agree after
    two epochs, device-resident or on host batches."""
    over = {"training.epochs": 2, "training.seed": 3, "training.device_data": device_data}
    jcfg, pcfg = bc_cfgs("None", dropout, **over)
    jt, jm, pt, pm = run_both(jcfg, pcfg, EPISODES, "bc", tmp_path, BC_S)
    assert pt.device_mode == device_data
    assert_trainers_agree(jt, jm, pt, pm, lambda p: convert.params_from_flax(p, pcfg))
    np.testing.assert_array_equal(pt._step_key, np.asarray(jt._step_key))


def test_vqvae_trainer_with_revive_matches_jax(tmp_path):
    """Two VQ-VAE epochs, each ending in a revive from fold_in(PRNGKey(77),
    epoch): the same dead codes revived, the same parameters."""
    jcfg, pcfg = vq_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.set_path("training.epochs", 2)
        cfg.set_path("training.seed", 1)
        cfg.set_path("dropout.num_embeddings", 64)
    episodes = dict(n_demos=2, steps=4, img_hw=(180, 320), max_points=3)
    revived = []
    revive = PV.make_revive_dead_codes

    def counting(model, cfg):
        fn = revive(model, cfg)

        def wrapped(params, batch, key):
            out = fn(params, batch, key)
            revived.append(int(out[1]))
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        import gabril_carla_tpu_torch.train.loop as loop

        mp.setattr(loop, "make_revive_dead_codes", counting)
        jt, jm, pt, pm = run_both(jcfg, pcfg, episodes, "vqvae", tmp_path, 2)
    assert revived[0] > 0 and pm["dead_codes"] == jm["dead_codes"] == revived[-1]
    assert_trainers_agree(jt, jm, pt, pm, lambda p: convert.vqvae_params_from_flax(p, pcfg))


# --- the sharded epochs' keys at 2 gloo ranks --------------------------------------


def test_sharded_step_keys_are_jax_rank_keys(tmp_path):
    """make_sharded_epoch_fn on 2 gloo ranks: rank r steps with JAX's
    fold_in(key, r) chain, split once a step (device_data.py:161, :165)."""
    from test_torch_parallel_ranks import SHARD_KEY, SHARD_STEPS, sharded_keys, spawn

    outs = spawn(sharded_keys, 2, tmp_path)
    for r, out in enumerate(outs):
        assert out["rank"] == r
        k = jax.random.fold_in(jax.random.PRNGKey(SHARD_KEY), r)
        want = []
        for _ in range(SHARD_STEPS):
            k, sub = jax.random.split(k)
            want.append(np.asarray(sub))
        bitwise(out["keys"], np.stack(want))
