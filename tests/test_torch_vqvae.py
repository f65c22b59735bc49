"""Port parity for the VQ-VAE (train/vqvae.py, models/vq.py trained, the
Trainer's mode "vqvae" and Oreo's pretrained quantizer).

The loss, metrics and gradients of one VQ-VAE step against the JAX
package's at 180x320 (the decoder's geometry needs the real frame) with
narrow widths, flax parameters converted: loss and metrics within rtol 1e-5,
each gradient leaf within 1e-4 of its scale (the bars of
test_torch_common.check_against_jax). The gradients come out of JAX's own
train step through an optimizer that keeps them as its state. Revive with JAX's draws: the same dead codes, the kept rows bitwise,
the revived ones at the encoder's float gap. Then the Trainer and the CLIs:
tests/test_vqvae.py's VQ-VAE-feeds-Oreo contract, the missing-path warning
and the manifest's model_type.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gabril_carla_tpu.train.vqvae as JV
from gabril_carla_tpu.data import BCDataset as JaxDataset
from gabril_carla_tpu.data import synthetic_episodes as jax_episodes
from gabril_carla_tpu.utils import default_bc_config as jax_default
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.cli import train_bc, train_vqvae
from gabril_carla_tpu_torch.data.dataset import BCDataset, synthetic_episodes
from gabril_carla_tpu_torch.train import vqvae as PV
from gabril_carla_tpu_torch.train.checkpoint import load_manifest, restore_params
from gabril_carla_tpu_torch.train.loop import Trainer
from gabril_carla_tpu_torch.utils.config import default_bc_config as port_default
from test_torch_common import cpu_threads, torch_batch

H, W, B = 180, 320, 4
# tests/test_vqvae.py's widths, as CLI overrides
TINY = ["data.img_height=180", "data.img_width=320", "data.frame_stack=2", "data.batch_size=4",
        "model.embedding_dim=4", "model.num_hiddens=8", "model.num_residual_layers=1",
        "model.num_residual_hiddens=4", "model.z_dim=16", "gaze.method=None", "gaze.max_points=3",
        "dropout.num_embeddings=16", "training.epochs=1", "training.compute_dtype=float32",
        "scheduler.type=none"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def cfgs():
    out = []
    for make in (jax_default, port_default):
        cfg = make()
        for kv in TINY:
            k, v = kv.split("=")
            cfg.set_path(k, v if not v.lstrip("-").isdigit() else int(v))
        out.append(cfg)
    return tuple(out)


def keep_grads():
    """An optax transformation whose state is the last gradient."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@functools.lru_cache(maxsize=None)
def jax_step():
    """(flax params, numpy batch, metrics, grads) of one JAX VQ-VAE step."""
    jcfg, _ = cfgs()
    (models, _), state = JV.init_vqvae_state(jcfg, jax.random.PRNGKey(0), keep_grads())
    store = jax_episodes(n_demos=1, steps=8, img_hw=(H, W), max_points=3)
    batch = next(JaxDataset(store, frame_stack=2, use_native=False).iter_batches(
        B, np.random.default_rng(0)))
    step = JV.make_vqvae_train_step(models, None, jcfg, donate=False)
    new, metrics = step(state, jax.tree.map(jnp.asarray, batch), None)
    params = jax.tree.map(np.asarray, state.params)
    return (params, batch, {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, new.opt_state))


def test_loss_and_grads_match_jax():
    params, batch, metrics, grads = jax_step()
    _, pcfg = cfgs()
    model = PV.build_vqvae_models(pcfg, "cpu")
    sd = convert.vqvae_params_from_flax(params, pcfg)
    assert set(sd) == set(model.state_dict())
    loss, got, g = PV.vqvae_loss_and_grads(model, pcfg, sd, torch_batch(batch))
    assert set(got) == set(metrics) == {"loss", "loss_recon", "loss_vq", "perplexity"}
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), metrics[k], rtol=1e-5, err_msg=k)
    want = convert.vqvae_params_from_flax(grads, pcfg)
    for k, w in want.items():
        bar = 1e-4 * float(w.abs().max())
        assert float(w.abs().max()) > 0, k  # every leaf takes a gradient, the codebook too
        assert float((g[k] - w).abs().max()) <= bar, (k, float((g[k] - w).abs().max()), bar)


def test_revive_with_jax_draws():
    """Six codebook rows moved far from every latent are dead and revived."""
    params, batch, _, _ = jax_step()
    params = jax.tree.map(np.copy, params)
    params["quantizer"]["codebook"][:6] = 5.0
    jcfg, pcfg = cfgs()
    models, _ = JV.build_vqvae_models(jcfg)
    key = jax.random.fold_in(jax.random.PRNGKey(77), 3)
    new, dead = JV.make_revive_dead_codes(models, jcfg)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch), key)
    k, d = 16, 4
    n_rows = B * (H // 8 - 2) * (W // 8 - 2)
    draws = {"pick": torch.from_numpy(np.array(jax.random.randint(key, (k,), 0, n_rows))),
             "jitter": torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 1), (k, d))))}
    model = PV.build_vqvae_models(pcfg, "cpu")
    sd = convert.vqvae_params_from_flax(params, pcfg)
    got, got_dead = PV.make_revive_dead_codes(model, pcfg)(sd, torch_batch(batch), draws)
    assert int(got_dead) == int(dead) >= 6
    want = np.asarray(new["quantizer"]["codebook"])
    kept = (want == params["quantizer"]["codebook"]).all(1)
    assert kept.sum() == k - int(dead)
    cb = got["quantizer.codebook"].numpy()
    np.testing.assert_array_equal(cb[kept], want[kept])
    np.testing.assert_allclose(cb[~kept], want[~kept], rtol=0, atol=1e-5)
    assert all(torch.equal(got[n], sd[n]) for n in sd if n != "quantizer.codebook")
    # the key itself draws JAX's picks bitwise and its jitter within 1e-6
    # relative (utils/prng.py normal), 0.01 of which moves a revived row
    again, again_dead = PV.make_revive_dead_codes(model, pcfg)(sd, torch_batch(batch), np.asarray(key))
    assert int(again_dead) == int(dead)
    np.testing.assert_allclose(again["quantizer.codebook"].numpy(), cb, rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def vq_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("vq")
    assert train_vqvae.main(TINY + [f"logging.log_dir={root}", "data.task=Vq"], device="cpu") == 0
    return root, next(root.glob("Vq/*/checkpoints"))


def test_vqvae_trains_and_feeds_oreo(vq_run):
    """tests/test_vqvae.py's contract through the CLIs: the VQ-VAE trains,
    Oreo BC adopts its encoder and quantizer bitwise and trains on."""
    root, ckpt = vq_run
    vq = restore_params(ckpt / "ep1")
    metrics = [json.loads(x) for x in (ckpt.parent / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(metrics[-1]["loss"]) and {"perplexity", "dead_codes"} <= set(metrics[-1])
    _, pcfg = cfgs()
    pcfg["dropout"].update(method="Oreo", vqvae_path=str(ckpt / "ep1"), oreo_num_mask=2)
    pcfg["logging"]["log_dir"] = str(root)
    ds = BCDataset(synthetic_episodes(n_demos=1, steps=8, img_hw=(H, W), max_points=3), 2)
    trainer = Trainer(pcfg, ds, mode="bc", device="cpu")
    assert torch.equal(trainer.state.params["quantizer.codebook"], vq["quantizer.codebook"])
    assert all(torch.equal(trainer.state.params[k], v) for k, v in vq.items() if k.startswith("encoder."))
    assert np.isfinite(trainer.train()["loss"])
    # the quantizer stays frozen through BC training
    assert torch.equal(trainer.state.params["quantizer.codebook"], vq["quantizer.codebook"])


def test_manifest_model_type(vq_run):
    assert load_manifest(vq_run[1] / "params.json")["model_type"] == "vqvae"


def test_missing_vqvae_path_warns(tmp_path, capsys):
    args = TINY + ["dropout.method=Oreo", f"dropout.vqvae_path={tmp_path / 'nowhere'}",
                   f"logging.log_dir={tmp_path}"]
    assert train_bc.main(args, device="cpu") == 0
    assert f"Warning: VQ-VAE model not found at {tmp_path / 'nowhere'}" in capsys.readouterr().out
