"""Port parity for utils/prng.py: the port's host threefry against
``jax.random`` under partitionable threefry (JAX's default here), bitwise.

``prng_key``, ``split``, ``fold_in``, ``random_bits32`` and ``uniform`` for
keys from five seeds (the last one eval_routes' key of route 27494 and
seed 401) and three shapes; the raw hash at rotations that carry across the
word; and ``env_draws`` against tests/test_torch_common.py's
``rollout_draws`` (JAX's own rollout chain) for 3 worlds x 50 ticks, with
a world's draws independent of the worlds beside it. The CLIs' draws
(eval_routes.pair_draws, collect.seed_draws) are JAX's for their keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gabril_carla_tpu_torch.cli import collect, eval_routes
from gabril_carla_tpu_torch.utils import prng
from test_torch_common import rollout_draws

SEEDS = (0, 1, 42, 2**31 - 1, 401 * 100003 + 27494)
SHAPES = ((), (2,), (5, 3))


def bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    bitwise(key, jkey)
    for n in (1, 2, 3, 7):
        bitwise(prng.split(key, n), jax.random.split(jkey, n))
    for data in (0, 1, 5, 2**32 - 1):
        bitwise(prng.fold_in(key, data), jax.random.fold_in(jkey, data))
    # keys of keys: a batch of split keys splits as each one does
    sub = prng.split(key, 3)
    bitwise(prng.split(sub), jax.vmap(jax.random.split)(jax.random.split(jkey, 3)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform(seed, shape):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    bitwise(prng.random_bits32(key, shape), jax.random.bits(jkey, shape, jnp.uint32))
    bitwise(prng.uniform(key, shape), jax.random.uniform(jkey, shape, jnp.float32))


def test_rotations_wrap():
    """Every rotation of the hash carries bits across the 32-bit word:
    all-ones and top-bit inputs hash as JAX's primitive does."""
    from jax._src.prng import threefry_2x32

    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xDEADBEEF], np.uint32)
    for k1 in words:
        for k2 in words[::-1]:
            want = np.asarray(threefry_2x32(jnp.array([k1, k2], jnp.uint32), jnp.asarray(words)))
            a, b = prng.threefry2x32(k1, k2, words[:3], words[3:])
            bitwise(np.concatenate([a, b]), want)
    for r in (13, 15, 26, 6, 17, 29, 16, 24):
        x = np.array([0x80000001], np.uint32)
        assert int(prng._rotl(x, r)[0]) == ((0x80000001 << r) | (0x80000001 >> (32 - r))) & 0xFFFFFFFF


def test_prng_key_range():
    with pytest.raises(ValueError):
        prng.prng_key(-1)
    bitwise(prng.prng_key(2**40 + 3), np.array([2**8, 3], np.uint32))


def test_env_draws_match_rollout_draws():
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = rollout_draws(keys, 50)
    got = prng.env_draws(np.asarray(keys), 50)
    bitwise(got, want)
    # a world's column does not depend on its neighbours
    bitwise(prng.env_draws(np.asarray(keys)[1:2], 50), want[:, 1:2])


def test_cli_draws_are_jax_keys():
    pairs = [(27494, 401), (3100, 400)]
    keys = jnp.stack([jax.random.PRNGKey(s * 100003 + r) for r, s in pairs])
    bitwise(eval_routes.pair_draws(pairs, 20, "cpu").numpy(), rollout_draws(keys, 20))
    seeds = [200, 3100 + 201 * 1000]
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    bitwise(collect.seed_draws(seeds, 20, "cpu").numpy(), rollout_draws(keys, 20))
