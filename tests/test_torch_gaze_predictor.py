"""Port parity: gaze-predictor training (train/gaze_predictor.py and the
Trainer's mode "gaze", train/loop.py) at 180x320 with tiny widths
(tests/test_gaze_keep_best.py's _gaze_cfg), float32.

Bars: the loss within rtol 1e-5 and every gradient leaf within 1e-4 of its
largest magnitude (tests/test_torch_common.py's bar for BC), against
jax.value_and_grad(gaze_loss_fn) on the same batch and converted
parameters; two optimizer steps against the JAX package's
make_gaze_train_step(jit=False), parameters within rtol 1e-4. The Trainer
writes ep<N>/params.pt and a manifest with model_type "gaze_predictor", and
its collapse gate restores the best epoch only past COLLAPSE_GATE x the
best loss (both cases of tests/test_gaze_keep_best.py).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState as FlaxState
from torch.func import functional_call

import gabril_carla_tpu.train.gaze_predictor as JG
from gabril_carla_tpu.train.optim import build_optimizer as j_build_optimizer
from gabril_carla_tpu.utils.config import default_gaze_config as j_default_gaze_config
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes
from gabril_carla_tpu_torch.models.unet import UNet
from gabril_carla_tpu_torch.train import gaze_predictor as PG
from gabril_carla_tpu_torch.train.checkpoint import load_manifest, restore_params
from gabril_carla_tpu_torch.train.loop import COLLAPSE_GATE, Trainer
from gabril_carla_tpu_torch.train.optim import TrainState, build_optimizer
from gabril_carla_tpu_torch.utils.config import default_gaze_config
from test_torch_common import bc_batch, torch_batch

B = 2


def gaze_cfgs(arch="autoencoder", **over):
    """(JAX config, port config), equal: _gaze_cfg's widths at 180x320."""
    out = []
    for make in (j_default_gaze_config, default_gaze_config):
        cfg = make()
        cfg["data"].update(img_height=180, img_width=320, frame_stack=2, batch_size=4, task="Gaze")
        cfg["model"].update(embedding_dim=4, num_hiddens=8, num_residual_layers=1,
                            num_residual_hiddens=4, z_dim=16, arch=arch)
        cfg["training"].update(epochs=1, compute_dtype="float32", save_interval=99)
        cfg["scheduler"]["type"] = "none"
        for k, v in over.items():
            cfg.set_path(k, v)
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def batch():
    return bc_batch(B, seed=4, hw=(180, 320), max_points=5)


@functools.lru_cache(maxsize=None)
def jax_grads(arch):
    jcfg, _ = gaze_cfgs(arch)
    tx = j_build_optimizer(jcfg.optimizer, jcfg.scheduler, jcfg.training, 10)
    (model, hm), state = JG.init_gaze_state(jcfg, jax.random.PRNGKey(0), tx)
    jb = jax.tree.map(jnp.asarray, batch())
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JG.gaze_loss_fn(p, model, hm, jcfg, jb), has_aux=True))(state.params)
    return jax.tree.map(np.asarray, state.params), float(loss), jax.tree.map(np.asarray, grads)


# conv biases whose output channel is a GroupNorm group of its own (8
# channels in 8 groups): the norm removes them, their exact gradient is 0
UNET_NULL = ("e1.convs.0.bias", "e1.convs.1.bias", "d1.convs.0.bias", "d1.convs.1.bias")


def grad_gaps(got: dict, want: dict, skip=()) -> dict:
    return {k: float((got[k].double() - w.double()).abs().max()) / float(w.abs().max())
            for k, w in want.items() if k not in skip}


@pytest.mark.parametrize("arch", ["autoencoder", "unet"])
def test_gaze_loss_and_grads_match_jax(arch):
    """The AutoEncoder at the BC bar (1e-4 of each leaf's scale). The UNet's
    GroupNorm is flax's, whose variance is E[x^2] - E[x]^2: in float32 that
    loses digits on these groups, and JAX's own gradients sit up to 4.5e-3
    of a leaf's scale from float64 (the port's F.group_norm: 1.4e-5, 2.7e-4
    at up1.bias). So the UNet is held to JAX at 1e-2 and to float64 at 1e-3,
    and its four bias leaves with a zero exact gradient (UNET_NULL) to zero."""
    params, loss, grads = jax_grads(arch)
    _, pcfg = gaze_cfgs(arch)
    model, hm = PG.build_gaze_models(pcfg, device="cpu")
    p_params = convert.gaze_params_from_flax(params, pcfg)
    p_loss, metrics, p_grads = PG.gaze_loss_and_grads(model, hm, pcfg, p_params, torch_batch(batch()))
    np.testing.assert_allclose(float(p_loss), loss, rtol=1e-5)
    assert float(metrics["loss"]) == float(p_loss)
    want = convert.gaze_params_from_flax(grads, pcfg)
    assert set(want) == set(p_grads)
    if arch == "autoencoder":
        assert max(grad_gaps(p_grads, want).values()) <= 1e-4
        return
    assert max(grad_gaps(p_grads, want, UNET_NULL).values()) <= 1e-2
    m64 = UNet(2, 1, torch.float64).double()
    b = torch_batch(batch())
    obs, target, _ = hm.prepare_for_gaze_predictor(b["obs_seq"], b["gaze_seq"], frame_stack=2,
                                                   grayscale=True)
    live = {k: v.double().requires_grad_() for k, v in p_params.items()}
    loss64 = torch.mean((functional_call(m64, live, (obs.double(),)) - target.double()) ** 2)
    g64 = dict(zip(live, torch.autograd.grad(loss64, list(live.values()))))
    assert max(grad_gaps(p_grads, g64, UNET_NULL).values()) <= 1e-3
    scale = max(float(g.abs().max()) for g in p_grads.values())
    assert all(float(p_grads[k].abs().max()) <= 1e-6 * scale for k in UNET_NULL)


def test_two_train_steps_match_jax():
    jcfg, pcfg = gaze_cfgs()
    params, _, _ = jax_grads("autoencoder")
    model, hm = JG.build_gaze_models(jcfg)
    jstep = JG.make_gaze_train_step(model, hm, jcfg, jit=False)
    jstate = FlaxState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, params),
                              tx=j_build_optimizer(jcfg.optimizer, jcfg.scheduler, jcfg.training, 10))
    pmodel, phm = PG.build_gaze_models(pcfg, device="cpu")
    step = PG.make_gaze_train_step(pmodel, phm, pcfg)
    state = TrainState.create(convert.gaze_params_from_flax(params, pcfg),
                              build_optimizer(pcfg.optimizer, pcfg.scheduler, pcfg.training, 10))
    batches = [batch(), bc_batch(B, seed=5, hw=(180, 320), max_points=5)]
    for b in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b), None)
        state, m = step(state, torch_batch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    want = convert.gaze_params_from_flax(jax.tree.map(np.asarray, jstate.params), pcfg)
    for k, w in want.items():
        np.testing.assert_allclose(state.params[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-7, err_msg=k)


def store():
    return synthetic_episodes(n_demos=1, steps=12, img_hw=(180, 320), max_points=5)


@pytest.mark.parametrize("arch", ["autoencoder", "unet"])
def test_trainer_gaze_writes_checkpoint(tmp_path, arch):
    _, pcfg = gaze_cfgs(arch, **{"logging.log_dir": str(tmp_path)})
    trainer = Trainer(pcfg, BCDataset(store(), 2), mode="gaze", device="cpu")
    last = trainer.train()
    assert set(last) == {"loss"} and np.isfinite(last["loss"])
    ckpt = trainer.logger.ckpt_dir
    restored = restore_params(ckpt / "ep1")
    assert set(restored) == set(trainer.model.state_dict())
    assert all(torch.equal(restored[k], trainer.state.params[k]) for k in restored)
    manifest = load_manifest(ckpt / "params.json")
    assert manifest["model_type"] == "gaze_predictor" and manifest["arch"] == arch
    assert manifest["epochs"] == 1
    lines = (trainer.logger.log_dir / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["step"] == trainer.steps_per_epoch


def scripted_trainer(tmp_path, losses):
    """A gaze Trainer whose epochs double every parameter and report the
    scripted losses (tests/test_gaze_keep_best.py's script)."""
    _, pcfg = gaze_cfgs(**{"logging.log_dir": str(tmp_path), "training.epochs": 4})
    tr = Trainer(pcfg, BCDataset(store(), 2), mode="gaze", device="cpu")
    it = iter(losses)

    def scripted_epoch(state, perm, rng):
        new = {k: v * 2.0 for k, v in state.params.items()}
        return TrainState(params=new, opt_state=state.opt_state, tx=state.tx,
                          step=state.step), {"loss": torch.tensor(next(it))}

    tr.epoch_fn = scripted_epoch
    return tr


def test_collapse_trips_gate_and_restores_best(tmp_path):
    # best 0.1 at epoch 2, then 0.9 (9x best > COLLAPSE_GATE): restore epoch 2
    tr = scripted_trainer(tmp_path, [0.5, 0.1, 0.9, 0.9])
    p0 = {k: v.clone() for k, v in tr.state.params.items()}
    m = tr.train()
    assert 0.9 > COLLAPSE_GATE * 0.1
    assert m["kept_best_epoch"] == 2 and abs(m["loss"] - 0.1) < 1e-6, m
    for k, v in tr.state.params.items():  # the epoch-2 snapshot: p0 * 2^2
        torch.testing.assert_close(v, p0[k] * 4.0, rtol=1e-6, atol=0)
    saved = restore_params(tr.logger.ckpt_dir / "ep4")  # re-written with them
    assert all(torch.equal(saved[k], tr.state.params[k]) for k in saved)


def test_mild_wobble_keeps_last_epoch(tmp_path):
    # final 0.12 is worse than the best 0.1 but within the gate: keep the last
    tr = scripted_trainer(tmp_path, [0.5, 0.1, 0.11, 0.12])
    p0 = {k: v.clone() for k, v in tr.state.params.items()}
    m = tr.train()
    assert "kept_best_epoch" not in m and abs(m["loss"] - 0.12) < 1e-6, m
    for k, v in tr.state.params.items():  # the last epoch's: p0 * 2^4
        torch.testing.assert_close(v, p0[k] * 16.0, rtol=1e-6, atol=0)
