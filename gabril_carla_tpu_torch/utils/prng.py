"""JAX's threefry random bits on the host, bit for bit.

The JAX package draws every env step's uniforms from threefry keys
(env/env.py:116-123, env/scenarios.py:51,65, env/ambient.py:111), split per
world from one key (eval/rollout.py:153) or made from a per-pair seed
(cli/eval_routes.py:111, cli/collect.py:78). This module reproduces those
bits with numpy ``uint32`` arithmetic (which wraps modulo 2**32), so the
port's eval and collection draw exactly JAX's numbers and a world's draws
do not depend on the worlds beside it.

It follows jax 0.9's partitionable threefry (``jax_threefry_partitionable``,
on by default): ``split`` and ``random_bits`` hash a 64-bit counter iota
split into (high, low) 32-bit halves; ``fold_in`` hashes the counter pair
(0, data). A key is a ``[..., 2]`` uint32 array; every function broadcasts
over the leading axes, so a batch of keys is one call.

``env_draws`` runs the whole chain of a rollout on the host before it
starts: the chain is sequential in ticks, and putting it on the card would
add launches to every tick.
"""

from __future__ import annotations

import numpy as np

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (jax/_src/prng.py
    _threefry2x32_lowering): the key (k1, k2) hashes the counters (x1, x2);
    all four broadcast together."""
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, np.uint32) for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    with np.errstate(over="ignore"):
        a, b = x1 + ks[0], x2 + ks[1]
        for i in range(5):
            for r in ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    """The row-major index of every element of ``shape`` as (high, low)
    uint32 halves (prng.py iota_2x32_shape)."""
    flat = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return (flat >> np.uint64(32)).astype(np.uint32), (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _hash_iota(key: np.ndarray, shape) -> tuple[np.ndarray, np.ndarray]:
    key = np.asarray(key, np.uint32)
    hi, lo = _iota_2x32(shape)
    pad = (...,) + (None,) * len(shape)
    return threefry2x32(key[..., 0][pad], key[..., 1][pad], hi, lo)


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: [..., n, 2] keys (_threefry_split_foldlike)."""
    return np.stack(_hash_iota(key, (n,)), axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the key hashing the counters
    (0, data) (threefry_fold_in)."""
    key = np.asarray(key, np.uint32)
    return np.stack(threefry2x32(key[..., 0], key[..., 1], 0, np.uint32(data & 0xFFFFFFFF)), axis=-1)


def random_bits32(key, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape)`` in uint32: the two hash words of each
    element's counter, xor-ed (_threefry_random_bits_partitionable)."""
    b1, b2 = _hash_iota(key, tuple(shape))
    return b1 ^ b2


def uniform(key, shape=()) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): 23 random
    mantissa bits under the exponent of 1.0, minus 1 (random.py _uniform)."""
    bits = (random_bits32(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def env_draws(keys, steps: int) -> np.ndarray:
    """[steps, B, 4] float32 uniforms of a JAX rollout whose B worlds were
    reset on ``keys`` [B, 2] and stepped with key=None: each tick splits a
    world's rng into the next rng and the step key (env.py:116-118), the
    step key into the scenario and ambient keys (:122), the scenario key
    into two flow keys (scenarios.py:51), the ambient key into the same-
    and opposite-direction keys (ambient.py:111), and each of those four
    draws one uniform (scenarios.py:65, ambient.py:111)."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    subs = np.empty((steps,) + keys.shape, np.uint32)
    rng = keys
    for t in range(steps):
        pair = split(rng)
        rng, subs[t] = pair[:, 0], pair[:, 1]
    return _step_key_draws(subs)


def tick_draws(rng) -> tuple[np.ndarray, np.ndarray]:
    """One tick of ``env_draws``, for a loop whose length is not known in
    advance: the worlds' rngs [B, 2] -> (their next rngs, this tick's draws
    [B, 4]). Starting from the reset keys, the n-th call's draws are
    ``env_draws(keys, n)[n - 1]``."""
    pair = split(np.asarray(rng, np.uint32).reshape(-1, 2))
    return pair[:, 0], _step_key_draws(pair[:, 1])


def _step_key_draws(subs: np.ndarray) -> np.ndarray:
    """Step keys [..., 2] -> their four uniforms [..., 4]: the scenario and
    ambient keys, each split into two leaves that draw one uniform."""
    scen_amb = split(subs)  # [..., 2, 2]
    leaves = np.concatenate([split(scen_amb[..., 0, :]), split(scen_amb[..., 1, :])], axis=-2)
    return uniform(leaves)
