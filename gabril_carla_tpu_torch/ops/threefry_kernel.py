"""JAX's random bits on the device: build, binding, wrapper and plain version.

``csrc/threefry.cu`` computes ``jax.random.uniform`` and
``jax.random.bernoulli`` (float32, partitionable threefry) on the card, so
the train steps draw JAX's dropout numbers where they run: at
bench_train.py's batch of 2000, IGMD alone draws 36.0 M uniforms a step.
It is compiled with nvcc for sm_90a at first use (ops/nvcc.py) and bound
with ctypes, as the render kernel is.

``uniform`` and ``bernoulli`` are the entries: on a CUDA device they launch
the kernel (or raise), on the CPU they run ``random_floats_plain``, the same
function in PyTorch int64 arithmetic masked to 32 bits. Both take a key as
utils/prng.py makes it (two uint32 words) and a counter ``offset``, so a
caller can draw a slice of a larger draw. utils/prng.py's numpy threefry
is the reference for both. ``threefry_kernel.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils.prng import KS_PARITY, ROTATIONS
from . import nvcc

SOURCE = nvcc.CSRC / "threefry.cu"
MASK = 0xFFFFFFFF


def build():
    """Compile csrc/threefry.cu (ops/nvcc.py build)."""
    return nvcc.build(SOURCE)


def _key_words(key) -> tuple[int, int]:
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(f"threefry: a key is two uint32 words, got {key.dtype} {key.shape}")
    return int(key[0]), int(key[1])


class ThreefryKernel:
    """ctypes binding of csrc/threefry.cu plus its launch count."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def load(self):
        if self._lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.threefry_floats_launch.argtypes = [
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int64, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.threefry_floats_launch.restype = ctypes.c_int
            lib.threefry_error_string.argtypes = [ctypes.c_int]
            lib.threefry_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, key, n: int, device, offset: int = 0, p: float | None = None) -> torch.Tensor:
        lib = self.load()
        k0, k1 = _key_words(key)
        out = torch.empty(n, dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.threefry_floats_launch(k0, k1, offset, n, 0.0 if p is None else float(np.float32(p)),
                                         int(p is not None), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"threefry kernel launch failed: {lib.threefry_error_string(err).decode()}")
        self.launches += 1
        return out


threefry_kernel = ThreefryKernel()


def random_floats(key, n: int, device, offset: int = 0, p: float | None = None) -> torch.Tensor:
    """[n] float32 on ``device``: element offset + i of ``uniform(key, ...)``
    (``p`` None) or of ``bernoulli(key, p, ...)`` as 0/1, for i < n: the
    kernel on a CUDA device, the plain version on the CPU."""
    device = torch.device(device)
    if offset < 0 or offset + n > 2**64:
        raise ValueError(f"threefry: counters [{offset}, {offset + n}) leave [0, 2**64)")
    if device.type == "cuda":
        return threefry_kernel(key, n, device, offset, p)
    if device.type == "cpu":
        return random_floats_plain(key, n, device, offset, p)
    raise ValueError(f"threefry: no kernel for device {device}")


def uniform(key, shape, device, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32, [0, 1)) on ``device``;
    with ``offset``, the elements from that flat index of a larger draw."""
    return random_floats(key, math.prod(shape), device, offset).reshape(shape)


def bernoulli(key, p: float, shape, device, offset: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` as float32 0/1 on ``device``;
    p (a Python float) is taken as float32, as JAX takes it."""
    return random_floats(key, math.prod(shape), device, offset, p).reshape(shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def random_floats_plain(key, n: int, device="cpu", offset: int = 0,
                        p: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: threefry in int64 tensors,
    every sum and shift masked to 32 bits, on ``device``."""
    k0, k1 = _key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ int(KS_PARITY))
    # counter offset + i as (high, low) words; int64 holds the low word's
    # carry, the high word of the offset is added apart
    c = torch.arange(n, dtype=torch.int64, device=device) + (offset & MASK)
    x0 = ((c >> 32) + (offset >> 32) + ks[0]) & MASK
    x1 = ((c & MASK) + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    bits = x0 ^ x1
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if p is None:
        return u
    return (u < float(np.float32(p))).to(torch.float32)
