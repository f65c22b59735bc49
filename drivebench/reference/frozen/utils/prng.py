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

import hashlib
import math

import numpy as np
import torch

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (jax/_src/prng.py
    _threefry2x32_lowering): the key (k1, k2) hashes the counters (x1, x2);
    all four broadcast together. In place on two work arrays: the init
    draws millions of words at once."""
    k1, k2, x1, x2 = (np.asarray(a, np.uint32) for a in (k1, k2, x1, x2))
    shape = np.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    a = np.empty(shape, np.uint32)
    b = np.empty(shape, np.uint32)
    t = np.empty(shape, np.uint32)
    np.add(x1, ks[0], out=a)
    np.add(x2, ks[1], out=b)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            np.add(a, b, out=a)
            np.left_shift(b, np.uint32(r), out=t)
            np.right_shift(b, np.uint32(32 - r), out=b)
            np.bitwise_or(b, t, out=b)
            np.bitwise_xor(b, a, out=b)
        np.add(a, ks[(i + 1) % 3], out=a)
        np.add(b, ks[(i + 2) % 3], out=b)
        np.add(b, np.uint32(i + 1), out=b)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _iota_2x32(shape, start: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The row-major index of every element of ``shape``, plus ``start``, as
    (high, low) uint32 halves (prng.py iota_2x32_shape); the high half is a
    0-d zero below 2**32."""
    n = math.prod(shape)
    if start + n <= 2**32:
        return np.zeros((), np.uint32), np.arange(start, start + n, dtype=np.uint32).reshape(shape)
    flat = np.arange(start, start + n, dtype=np.uint64).reshape(shape)
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


CHUNK = 1 << 16  # elements a pass: the work arrays of a chunk stay in the CPU's cache


def random_bits32(key, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape)`` in uint32: the two hash words of each
    element's counter, xor-ed (_threefry_random_bits_partitionable). A
    large draw from one key is hashed CHUNK counters at a time."""
    key = np.asarray(key, np.uint32)
    n = math.prod(shape)
    if key.shape != (2,) or n <= CHUNK:
        b1, b2 = _hash_iota(key, tuple(shape))
        return b1 ^ b2
    out = np.empty(n, np.uint32)
    for start in range(0, n, CHUNK):
        hi, lo = _iota_2x32((min(CHUNK, n - start),), start)
        a, b = threefry2x32(key[0], key[1], hi, lo)
        np.bitwise_xor(a, b, out=out[start:start + len(lo)])
    return out.reshape(shape)


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32: 23
    random mantissa bits under the exponent of 1.0, minus 1, then scaled
    to [minval, maxval) and held at minval (random.py _uniform)."""
    bits = (random_bits32(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    if minval == 0.0 and maxval == 1.0:  # floats * 1 + 0, exactly
        return floats
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, fma32(floats, hi - lo, lo))


def fma32(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding, as XLA contracts a float32
    multiply-add on the host: the float64 product of two float32 values is
    exact, so only the sum rounds (twice, to float64 and to float32, which
    agrees with a fused multiply-add but at rare double-rounding ties)."""
    t = np.multiply(a, b, dtype=np.float64)
    t += c
    return t.astype(np.float32)


def bernoulli(key, p: float, shape=()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low"): a uniform below
    p, with a Python float p taken as float32 (random.py _bernoulli)."""
    return uniform(key, shape) < np.float32(p)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32: two
    words a draw from ``split(key)``, reduced modulo the span in uint32
    arithmetic with JAX's multiplier 2**32 mod span (random.py
    _randint)."""
    if minval < -2**31 or maxval > 2**31 - 1:
        raise ValueError(f"randint bounds must be int32, got [{minval}, {maxval})")
    k1, k2 = split(key)
    higher, lower = random_bits32(k1, shape), random_bits32(k2, shape)
    span = np.uint32(1 if maxval <= minval else maxval - minval)
    multiplier = np.uint32((2**16 % int(span)) ** 2 % 2**32 % int(span))  # uint32 product
    offset = (higher % span) * multiplier + lower % span
    return np.int32(minval) + (offset % span).astype(np.int32)


# the float32 inverse error function XLA lowers erf_inv to (Giles' single
# precision polynomials in w = -log1p(-x**2), split at w = 5, evaluated by
# Horner's rule in fused multiply-adds)
_ERF_INV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                   0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``, evaluated in numpy float32, CHUNK elements
    at a time; +-1 map to +-inf. numpy's ``log1p`` is not XLA's, so a result
    may differ from JAX's in its last bits (tests/test_torch_train_draws.py
    holds the normals built on it within 1e-6 relative)."""
    x = np.asarray(x, np.float32)
    flat, out = x.reshape(-1), np.empty(x.size, np.float32)
    for start in range(0, flat.size, CHUNK):
        xs = flat[start:start + CHUNK]
        w = -np.log1p(-(xs * xs))
        small = w < np.float32(5.0)
        p = np.empty_like(xs)
        for mask, coeffs in ((small, _ERF_INV_W_LT_5), (~small, _ERF_INV_W_GE_5)):
            if not mask.any():
                continue
            wm = w[mask]
            wm = wm - np.float32(2.5) if coeffs is _ERF_INV_W_LT_5 else np.sqrt(wm) - np.float32(3.0)
            pm = np.full_like(wm, coeffs[0])
            for c in coeffs[1:]:
                pm = fma32(pm, wm, np.float32(c))
            p[mask] = pm
        with np.errstate(over="ignore"):
            out[start:start + CHUNK] = np.where(np.abs(xs) == np.float32(1.0),
                                                xs * np.finfo(np.float32).max, p * xs)
    return out.reshape(x.shape)


SQRT2 = np.float32(np.sqrt(2))


def normal(key, shape=()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: sqrt(2) *
    erf_inv(uniform on [nextafter(-1, 0), 1)) (random.py _normal_real)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return SQRT2 * erf_inv32(uniform(key, shape, lo, 1.0))


def truncated_normal(key, lower: float, upper: float, shape=()) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32
    (random.py _truncated_normal): erf_inv of a uniform between erf of the
    two bounds, clipped inside them."""
    lower, upper = np.float32(lower), np.float32(upper)
    a, b = (np.float32(math.erf(float(v / SQRT2))) for v in (lower, upper))
    out = SQRT2 * erf_inv32(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lower, np.float32(np.inf)),
                   np.nextafter(upper, np.float32(-np.inf)))


def orthogonal(key, shape, scale: float = 1.0) -> np.ndarray:
    """``jax.nn.initializers.orthogonal(scale)(key, shape)`` (column axis
    -1; nn/initializers.py orthogonal, random.py orthogonal): a normal
    [max(n, m), min(n, m)] matrix for n = prod(shape[:-1]) rows and m =
    shape[-1] columns, its reduced QR's Q times sign(diag(R)), transposed
    when n < m, reshaped to ``shape`` and scaled. That Q (R's diagonal made
    positive) is unique; it is factored here in float64 (torch's LAPACK,
    multithreaded: the pre-actor's [48640, 256] takes a fifth of a second)
    and rounded, where JAX factors in float32, so the two differ by JAX's
    rounding."""
    m = shape[-1]
    n = math.prod(shape) // m
    q, r = torch.linalg.qr(torch.from_numpy(normal(key, (max(n, m), min(n, m)))).double())
    q = (q * torch.sign(torch.diagonal(r))[None, :]).numpy().astype(np.float32)
    if n < m:
        q = q.T
    return np.float32(scale) * q.reshape(shape)


def lecun_normal(key, shape) -> np.ndarray:
    """``jax.nn.initializers.lecun_normal()(key, shape)``, flax's default
    kernel init: ``variance_scaling(1, "fan_in", "truncated_normal")``,
    fan in the product of all axes but the last."""
    fan_in = math.prod(shape[:-1])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
    return truncated_normal(key, -2, 2, shape) * stddev


def flax_fold(key, *path) -> np.ndarray:
    """The key a flax scope derives for the names and counters ``path``
    (flax/core/scope.py _fold_in_static, flax 0.12.3 with
    ``flax_fix_rng_separator`` off): ``fold_in`` of the first four bytes of
    the SHA-1 over the path's strings (UTF-8) and ints (big endian, no
    leading zeros). A parameter's init key is its module path from the
    root module of ``init`` with its rank among the module's parameters
    (1, 2, ...): ``flax_fold(key, "Conv_0", 1)`` is the kernel of the root's
    first Conv. The n-th ``make_rng("dropout")`` of a root scope is
    ``flax_fold(key, n)``."""
    if not path:
        return np.asarray(key, np.uint32)
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


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
