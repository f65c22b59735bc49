"""Port parity for the training draws: utils/prng.py's jax.random ports,
flax's keys, ops/threefry_kernel.py, and the keyed init, step draws and
revive of train/bc.py, train/gaze_predictor.py and train/vqvae.py
(whole Trainers of the two packages from one seed are in
tests/test_torch_train_draws_trainers.py).

Bars: bits, uniforms, Bernoulli masks, randint picks and the folded keys
bitwise; normals and truncated normals within 1e-6 relative (XLA's float32
``erf_inv`` takes its ``log1p`` from XLA, the port from numpy: measured at
most 2.4e-7); orthogonal and lecun-normal kernels within 1e-6 (the QR's
float32 rounding); every init within 1e-5 of JAX's through ``convert``;
each step's GMD, IGMD and Oreo draws and the revive's picks bitwise.
"""

from __future__ import annotations

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gabril_carla_tpu.train.bc as JB
import gabril_carla_tpu.train.gaze_predictor as JG
import gabril_carla_tpu.train.vqvae as JV
from gabril_carla_tpu_torch import convert
from gabril_carla_tpu_torch.ops import threefry_kernel as TK
from gabril_carla_tpu_torch.train import bc as PB
from gabril_carla_tpu_torch.train import gaze_predictor as PG
from gabril_carla_tpu_torch.train import vqvae as PV
from gabril_carla_tpu_torch.train.optim import build_optimizer
from gabril_carla_tpu_torch.utils import prng
from test_torch_common import bc_cfgs, cpu_threads, jax_bc_draws
from test_torch_gaze_predictor import gaze_cfgs
from test_torch_vqvae import cfgs as vq_cfgs

SEEDS = (0, 3, 2**31 - 1)
SHAPES = ((7,), (33, 5), (4, 1, 11, 20))
NORMAL_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


def bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def keys(seed):
    return prng.prng_key(seed), jax.random.PRNGKey(seed)


# --- utils/prng.py against jax.random and jax.nn.initializers ---------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_and_randint_bitwise(seed, shape):
    key, jkey = keys(seed)
    for p in (0.5, 1.0 - 0.3, 1e-3):
        bitwise(prng.bernoulli(key, p, shape), jax.random.bernoulli(jkey, p, shape))
    # the revive's span (probe latents at 180x320) and spans whose square
    # wraps uint32, the empty span
    for lo, hi in ((0, 512 * 20 * 38), (0, 7), (-5, 2**31 - 1), (3, 3), (0, 65537)):
        bitwise(prng.randint(key, shape, lo, hi), jax.random.randint(jkey, shape, lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_truncated_normal(seed):
    key, jkey = keys(seed)
    shape = (300, 170)
    want = np.asarray(jax.random.normal(jkey, shape))
    np.testing.assert_allclose(prng.normal(key, shape), want, rtol=NORMAL_RTOL, atol=0)
    for lo, hi in ((-2.0, 2.0), (-1.0, 3.0)):
        want = np.asarray(jax.random.truncated_normal(jkey, lo, hi, shape))
        got = prng.truncated_normal(key, lo, hi, shape)
        assert got.dtype == np.float32 and got.min() > lo and got.max() < hi
        np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    bitwise(prng.uniform(key, shape, lo, 1.0), jax.random.uniform(jkey, shape, jnp.float32, lo, 1.0))
    bitwise(prng.uniform(key, shape, -0.95449972, 0.95449972),
            jax.random.uniform(jkey, shape, jnp.float32, -0.95449972, 0.95449972))


def test_large_draws_bitwise():
    """A draw of more than prng.CHUNK elements is hashed a chunk at a time:
    still JAX's bits, uniforms and normals."""
    key, jkey = keys(17)
    shape = (3, prng.CHUNK + 5)
    bitwise(prng.random_bits32(key, shape), jax.random.bits(jkey, shape, jnp.uint32))
    bitwise(prng.uniform(key, shape), jax.random.uniform(jkey, shape, jnp.float32))
    np.testing.assert_allclose(prng.normal(key, shape), np.asarray(jax.random.normal(jkey, shape)),
                               rtol=NORMAL_RTOL, atol=0)


@pytest.mark.parametrize("shape", [(4, 4, 2, 4), (3, 3, 16, 16), (640, 16), (16, 7), (2, 2, 32, 16)],
                         ids=str)
def test_orthogonal_and_lecun_normal(shape):
    key, jkey = keys(9)
    for scale in (1.0, math.sqrt(2.0)):
        want = np.asarray(jax.nn.initializers.orthogonal(scale)(jkey, shape))
        np.testing.assert_allclose(prng.orthogonal(key, shape, scale), want, rtol=0, atol=1e-6)
    want = np.asarray(jax.nn.initializers.lecun_normal()(jkey, shape))
    np.testing.assert_allclose(prng.lecun_normal(key, shape), want, rtol=NORMAL_RTOL, atol=0)


class _Probe(fnn.Module):
    """Each parameter is the key flax hands its initializer."""

    @fnn.compact
    def __call__(self):
        return self.param("a", lambda k: k), self.param("b", lambda k: k)


class _Nest(fnn.Module):
    @fnn.compact
    def __call__(self):
        _Probe()()
        _Probe()()
        return _Inner(name="encoder")()


class _Inner(fnn.Module):
    @fnn.compact
    def __call__(self):
        return _Probe()(), self.make_rng("dropout"), self.make_rng("dropout")


def test_flax_folded_keys():
    """Parameter keys by module path and rank, and make_rng's keys, as flax
    0.12.3 derives them (flax/core/scope.py)."""
    key, jkey = keys(21)
    drop, jdrop = keys(22)
    (_, d1, d2), var = _Nest().init_with_output({"params": jkey, "dropout": jdrop})
    p = var["params"]
    for path in (("_Probe_0",), ("_Probe_1",), ("encoder", "_Probe_0")):
        leaf = p
        for name in path:
            leaf = leaf[name]
        bitwise(prng.flax_fold(key, *path, 1), leaf["a"])
        bitwise(prng.flax_fold(key, *path, 2), leaf["b"])
    bitwise(prng.flax_fold(drop, "encoder", 1), d1)
    bitwise(prng.flax_fold(drop, "encoder", 2), d2)
    bitwise(prng.flax_fold(key), key)
    # the encoder's IGMD keys: make_rng at the root scope of its apply
    j1, j2 = _DropoutProbe().apply({}, rngs={"dropout": jdrop})
    bitwise(prng.flax_fold(drop, 1), j1)
    bitwise(prng.flax_fold(drop, 2), j2)


class _DropoutProbe(fnn.Module):
    def __call__(self):
        return self.make_rng("dropout"), self.make_rng("dropout")


# --- ops/threefry_kernel.py: the plain version (the kernel runs on the card) -


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_plain_is_jax_uniform(seed, shape):
    key, jkey = keys(seed)
    sub, jsub = prng.split(key)[1], jax.random.split(jkey)[1]
    got = TK.uniform(sub, shape, "cpu")
    bitwise(got.numpy(), prng.uniform(sub, shape))
    bitwise(got.numpy(), jax.random.uniform(jsub, shape, jnp.float32))
    got = TK.bernoulli(sub, 1.0 - 0.3, shape, "cpu")
    bitwise(got.numpy(), np.asarray(jax.random.bernoulli(jsub, 1.0 - 0.3, shape), np.float32))
    # a slice of a draw is the draw's elements from that flat index
    n = math.prod(shape)
    bitwise(TK.random_floats(sub, n - 3, "cpu", offset=3).numpy(), prng.uniform(sub, (n,))[3:])


@pytest.mark.parametrize("offset", [2**32 - 6, 5 * 2**32 + 7, 2**64 - 12])
def test_threefry_plain_high_counter_word(offset):
    """Elements of a draw of more than 2**32 elements, computed at their
    counter offset alone: the high word of the counter is hashed."""
    key = prng.split(prng.prng_key(5))[0]
    c = offset + np.arange(12, dtype=np.uint64)
    a, b = prng.threefry2x32(key[0], key[1], (c >> np.uint64(32)).astype(np.uint32),
                             (c & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    want = (((a ^ b) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    bitwise(TK.random_floats(key, 12, "cpu", offset=offset).numpy(), want)
    bitwise(TK.random_floats(key, 12, "cpu", offset=offset, p=0.25).numpy(),
            (want < np.float32(0.25)).astype(np.float32))
    with pytest.raises(ValueError):
        TK.random_floats(key, 13, "cpu", offset=2**64 - 12)


def test_threefry_wrapper_never_falls_back():
    """On a CUDA device the wrapper launches the kernel or raises (here: no
    nvcc or no card); a bad key or device raises; nothing is counted."""
    before = TK.threefry_kernel.launches
    with pytest.raises((RuntimeError, AssertionError)):
        TK.uniform(prng.prng_key(0), (4,), "cuda")
    with pytest.raises(ValueError):
        TK.uniform(prng.prng_key(0), (4,), "meta")
    with pytest.raises(ValueError):
        TK.uniform(np.array([1, 2], np.int64), (4,), "cpu")
    assert TK.threefry_kernel.launches == before


# --- the keyed init against JAX's --------------------------------------------


@pytest.mark.parametrize("gaze,dropout", [("None", "None"), ("AGIL", "None"), ("GRIL", "None"),
                                          ("None", "Oreo"), ("ViSaRL", "IGMD")])
def test_init_bc_params_matches_jax(gaze, dropout):
    jcfg, pcfg = bc_cfgs(gaze, dropout)
    flax_params = JB.init_bc_params(JB.build_bc_models(jcfg), jcfg, jax.random.PRNGKey(4))
    want = convert.params_from_flax(jax.tree.map(np.asarray, flax_params), pcfg)
    models = PB.build_bc_models(pcfg, device="cpu")
    got = PB.init_bc_params(models, pcfg, prng.prng_key(4))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=k)
    assert all(torch.equal(got[k], v) for k, v in models.state_dict().items())


@pytest.mark.parametrize("arch", ["autoencoder", "unet"])
def test_init_gaze_params_matches_jax(arch):
    jcfg, pcfg = gaze_cfgs(arch)
    _, state = JG.init_gaze_state(jcfg, jax.random.PRNGKey(6), optax.sgd(0.0))
    want = convert.gaze_params_from_flax(jax.tree.map(np.asarray, state.params), pcfg)
    pmodel, _ = PG.build_gaze_models(pcfg, device="cpu")
    got = PG.init_gaze_params(pmodel, pcfg, prng.prng_key(6))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_init_vqvae_state_matches_jax():
    jcfg, pcfg = vq_cfgs()
    _, state = JV.init_vqvae_state(jcfg, jax.random.PRNGKey(8), optax.sgd(0.0))
    want = convert.vqvae_params_from_flax(jax.tree.map(np.asarray, state.params), pcfg)
    tx = build_optimizer(pcfg.optimizer, pcfg.scheduler, pcfg.training, 1)
    _, pstate = PV.init_vqvae_state(pcfg, prng.prng_key(8), tx, device="cpu")
    assert set(pstate.params) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(pstate.params[k].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=k)


# --- the step's draws and the revive's ------------------------------------------


@pytest.mark.parametrize("dropout,over", [("GMD", {}), ("IGMD", {}), ("Oreo", {}),
                                          ("Oreo", {"dropout.oreo_num_mask": 1})])
def test_step_draws_are_jax_draws(dropout, over):
    jcfg, pcfg = bc_cfgs("Reg", dropout, **over)
    for seed in (1, 12):
        key, jkey = keys(seed)
        want = jax_bc_draws(jcfg, jkey, 6)
        got = PB.step_draws(key, pcfg, 6, "cpu")
        assert set(got) == set(want)
        for k in want:
            for a, b in zip(*(v if k == "igmd" else [v] for v in (got[k], want[k]))):
                bitwise(a.numpy(), b.numpy())
        # a rank's rows of a global batch of 12 (the host path under a mesh)
        glob = PB.step_draws(key, pcfg, 12, "cpu")
        rows = PB.step_draws(key, pcfg, 4, "cpu", rows=(4, 12))
        for k in glob:
            g, r = (glob[k], rows[k]) if k == "igmd" else ([glob[k]], [rows[k]])
            for a, b in zip(g, r):
                if k == "oreo":  # m-major: each of the m blocks of 12 rows
                    m = a.shape[0] // 12
                    a = torch.cat([a[j * 12 + 4:j * 12 + 8] for j in range(m)])
                else:
                    a = a[4:8]
                bitwise(b.numpy(), a.numpy())


def test_revive_draws_are_jax_draws():
    key, jkey = keys(77)
    for epoch in (0, 3):
        k, jk = prng.fold_in(key, epoch), jax.random.fold_in(jkey, epoch)
        d = PV.revive_draws(k, 512 * 20 * 38, 512, 64, "cpu")
        bitwise(d["pick"].numpy(), jax.random.randint(jk, (512,), 0, 512 * 20 * 38))
        np.testing.assert_allclose(d["jitter"].numpy(),
                                   np.asarray(jax.random.normal(jax.random.fold_in(jk, 1), (512, 64))),
                                   rtol=NORMAL_RTOL, atol=0)
