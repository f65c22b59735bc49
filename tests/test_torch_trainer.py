"""Port parity: the data and the training loop (data/dataset.py,
train/device_data.py, train/checkpoint.py, train/loop.py) at 24x48.

Bars: the synthetic episodes, host batches and device windows equal the JAX
package's exactly; an epoch of make_epoch_fn equals the same steps run one
by one bitwise (same operations in the same order), and the JAX package's
epoch from the same key, nothing replayed, within 2e-5 in every parameter: two Adam
steps of lr 5e-4 on float32 gradients that agree to 1e-4 of their scale,
but Adam divides a gradient by its own magnitude plus 1e-8, so where a
gradient is near 1e-8 its float32 noise shows in the step (measured 7.3e-6
at 2 of 2,048 weights, under 1e-7 elsewhere).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.train.bc as JB
from gabril_carla_tpu.data import BCDataset as JDataset
from gabril_carla_tpu.data import synthetic_episodes as j_synthetic
from gabril_carla_tpu.train.checkpoint import save_manifest as j_save_manifest
from gabril_carla_tpu.train.device_data import DeviceData as JDeviceData
from gabril_carla_tpu.train.device_data import make_epoch_fn as j_make_epoch_fn
from gabril_carla_tpu.train.optim import build_optimizer as j_build_optimizer
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.train.checkpoint import latest_resume_state, load_manifest, restore_params
from gabril_carla_tpu_torch.train.device_data import DeviceData, gather_from, make_epoch_fn
from gabril_carla_tpu_torch.train.loop import Trainer
from gabril_carla_tpu_torch.train.optim import TrainState, build_optimizer
from gabril_carla_tpu_torch.utils.prng import prng_key, split
from test_torch_common import BC_A, BC_H, BC_P, BC_S, BC_W, KEY, bc_cfgs

EPISODES = dict(n_demos=2, steps=6, img_hw=(BC_H, BC_W), max_points=BC_P, action_dim=BC_A, seed=3)


def test_synthetic_episodes_and_batches_equal():
    js, ps = j_synthetic(**EPISODES), synthetic_episodes(**EPISODES)
    for a, b in zip(js.images + js.gazes + js.actions, ps.images + ps.gazes + ps.actions):
        np.testing.assert_array_equal(a, b)
    jd, pd = JDataset(js, frame_stack=3, use_native=False), BCDataset(ps, frame_stack=3)
    assert len(jd) == len(pd) and jd.steps_per_epoch(4) == pd.steps_per_epoch(4)
    for jb, pb in zip(jd.iter_batches(4, np.random.default_rng(1)), pd.iter_batches(4, np.random.default_rng(1))):
        for k in jb:
            np.testing.assert_array_equal(pb[k], jb[k])


@pytest.mark.parametrize("grayscale", [True, False])
def test_device_windows_equal(grayscale):
    jdd = JDeviceData(j_synthetic(**EPISODES), 3, grayscale_store=grayscale)
    pdd = DeviceData(synthetic_episodes(**EPISODES), 3, grayscale_store=grayscale, device="cpu")
    assert pdd.n_samples == jdd.n_samples
    for k, v in jdd.arrays().items():
        np.testing.assert_array_equal(pdd.arrays()[k].numpy(), np.asarray(v), err_msg=k)
    idx = np.array([0, 5, 6, 11, 2])
    want = jax.device_get(jdd.gather(jnp.asarray(idx)))
    got = pdd.gather(torch.from_numpy(idx))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def epoch_setup(gaze="Reg", dropout="GMD"):
    jcfg, pcfg = bc_cfgs(gaze, dropout)
    models = JB.build_bc_models(jcfg)
    flax_params = JB.init_bc_params(models, jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_flax(jax.tree.map(np.asarray, flax_params), pcfg)
    data = DeviceData(synthetic_episodes(**EPISODES), BC_S, device="cpu")
    pmodels = PB.build_bc_models(pcfg, device="cpu")
    tx = build_optimizer(pcfg.optimizer, pcfg.scheduler, pcfg.training, 3)
    return jcfg, pcfg, flax_params, params, data, pmodels, tx


def test_epoch_equals_steps_one_by_one():
    _, pcfg, _, params, data, models, tx = epoch_setup()
    step = PB.make_bc_train_step(models, pcfg)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(data.n_samples))
    state, metrics = make_epoch_fn(data, step, 3, 4)(TrainState.create(params, tx), perm, prng_key(7))
    ref = TrainState.create(params, tx)
    losses, key, draws = [], prng_key(7), []
    for i in range(3):
        key, sub = split(key)  # the epoch splits its key once a step
        draws.append(PB.step_draws(sub, pcfg, 4, "cpu"))
        ref, m = step(ref, gather_from(data.arrays(), perm[4 * i:4 * i + 4]), sub)
        losses.append(m["loss"])
    assert state.step == ref.step == 3
    for k in params:
        assert torch.equal(state.params[k], ref.params[k]), k
    assert torch.equal(metrics["loss"], torch.stack(losses).mean())
    with pytest.raises(ValueError):
        make_epoch_fn(data, step, 3, 4)(TrainState.create(params, tx), perm, draws[:2])


@pytest.mark.parametrize("gaze,dropout", [("Reg", "GMD"), ("AGIL", "IGMD"), ("None", "Oreo")])
def test_epoch_matches_jax_epoch(gaze, dropout):
    """Two steps of the JAX package's jitted epoch scan against the port's
    epoch from the same key: the port splits it and draws each step's
    dropout as JAX does, with nothing replayed."""
    jcfg, pcfg, flax_params, params, data, models, tx = epoch_setup(gaze, dropout)
    jdata = JDeviceData(j_synthetic(**EPISODES), BC_S)
    jtx = j_build_optimizer(jcfg.optimizer, jcfg.scheduler, jcfg.training, 3)
    from flax.training.train_state import TrainState as FlaxState

    if dropout == "Oreo":
        import optax

        jtx = optax.masked(jtx, lambda p: {k: k != "quantizer" for k in p})
        tx = PB.masked(tx, ("quantizer.",))
    jstep = JB.make_bc_train_step(JB.build_bc_models(jcfg), jcfg, jit=False)
    perm = np.random.default_rng(5).permutation(data.n_samples)
    jstate, jmetrics = j_make_epoch_fn(jdata, jstep, 2, 4)(
        FlaxState.create(apply_fn=None, params=flax_params, tx=jtx), jnp.asarray(perm), KEY)
    state, metrics = make_epoch_fn(data, PB.make_bc_train_step(models, pcfg), 2, 4)(
        TrainState.create(params, tx), torch.from_numpy(perm), np.asarray(KEY))
    want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params), pcfg)
    for k, w in want.items():
        np.testing.assert_allclose(state.params[k].numpy(), w.numpy(), atol=2e-5, rtol=0, err_msg=k)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("device_data", [True, False])
def test_trainer_epoch_writes_checkpoint(tmp_path, device_data):
    jcfg, pcfg = bc_cfgs("Reg", "IGMD", **{"logging.log_dir": str(tmp_path),
                                           "training.device_data": device_data})
    trainer = Trainer(pcfg, BCDataset(synthetic_episodes(**EPISODES), BC_S), device="cpu")
    assert trainer.device_mode == device_data
    last = trainer.train()
    assert set(last) == {"loss", "loss_actor", "loss_reg"} and np.isfinite(last["loss"])
    ckpt = trainer.logger.ckpt_dir
    restored = restore_params(ckpt / "ep1")
    assert set(restored) == set(trainer.state.params)
    assert all(torch.equal(restored[k], trainer.state.params[k]) for k in restored)
    j_save_manifest(tmp_path / "jax", jcfg, 1)
    want = json.loads((tmp_path / "jax" / "params.json").read_text())
    got = load_manifest(ckpt / "params.json")
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "models_path"} == {
        k: v for k, v in want.items() if k != "models_path"}
    lines = (trainer.logger.log_dir / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["step"] == trainer.steps_per_epoch


@pytest.mark.parametrize("case", ["gaze", "vqvae", "vqvae_path", "resume"])
def test_trainer_ported_parts_run(tmp_path, case):
    """The parts that waited before this slice now run: resume in the
    gaze-predictor mode ("gaze"), the VQ-VAE, Oreo with a pretrained VQ-VAE
    and BC resume (tests/test_torch_resume.py and test_torch_vqvae.py hold
    them to their contracts)."""
    over = {"logging.log_dir": str(tmp_path)}
    hw = (24, 48)
    if case in ("gaze", "vqvae", "vqvae_path"):  # the decoder needs 180x320
        hw = (180, 320)
        over.update({"data.img_height": 180, "data.img_width": 320, "model.num_hiddens": 8,
                     "model.embedding_dim": 4, "model.num_residual_hiddens": 4})
    if case == "vqvae_path":
        _, vcfg = bc_cfgs(**over)
        vq = Trainer(vcfg, BCDataset(synthetic_episodes(**{**EPISODES, "img_hw": hw}), BC_S),
                     mode="vqvae", device="cpu")
        vq.train()
        over.update({"dropout.method": "Oreo", "dropout.vqvae_path": str(vq.logger.ckpt_dir / "ep1")})
    _, pcfg = bc_cfgs(**over)
    ds = BCDataset(synthetic_episodes(**{**EPISODES, "img_hw": hw}), BC_S)
    trainer = Trainer(pcfg, ds, mode=case if case in ("gaze", "vqvae") else "bc", device="cpu")
    last = trainer.train(resume=case in ("resume", "gaze"))
    assert np.isfinite(last["loss"])
    resumable = latest_resume_state(trainer.logger.ckpt_dir)
    assert (resumable is not None) == (case in ("resume", "gaze"))
    if case == "vqvae_path":
        assert torch.equal(trainer.state.params["quantizer.codebook"],
                           vq.state.params["quantizer.codebook"])
