"""The native batch gather: build, ctypes binding and wrappers.

``csrc/gather.cpp`` (the port's copy of the JAX package's
native/gather.cpp, the same C ABI) is compiled with g++ at first use
(``build``) into ``gabril_carla_tpu_torch/_build/``, keyed by the hash of
its source, its flags and the host CPU's features (``-march=native``), and
loaded with ctypes (``load``). A failed build raises with the compiler's
output; nothing here falls back to numpy. data/dataset.py's ``BCDataset``
takes its numpy loop only for lazy stores or when asked
(``use_native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "gather.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib = None


def _host_features() -> bytes:
    """The CPU feature flags ``-march=native`` compiles for, so that a build
    directory copied to another machine is not reused there."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.processor().encode()
    return next((ln for ln in text.splitlines() if ln.startswith("flags")), "").encode()


def build() -> Path:
    """Compile csrc/gather.cpp with ``CXX`` unless a library built from the
    same source, flags and host exists; returns its path. Raises
    RuntimeError when the compiler is missing or fails."""
    key = SOURCE.read_bytes() + " ".join((CXX, *CXX_FLAGS)).encode() + _host_features()
    lib = BUILD_DIR / f"libgather_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"native gather: the compiler {CXX!r} is not on PATH")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load():
    """The bound library, built at the first call of the process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64p = ctypes.POINTER(ctypes.c_int64)
        windows = [ctypes.c_void_p, i64p, i64p, ctypes.c_int64, i64p, i64p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        for name in ("gather_windows_u8", "gather_windows_f32"):
            getattr(lib, name).argtypes = windows
            getattr(lib, name).restype = None
        lib.gather_rows_f32.argtypes = [ctypes.c_void_p, i64p, i64p, ctypes.c_int64, i64p, i64p,
                                        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        lib.gather_rows_f32.restype = None
        _lib = lib
    return _lib


def _threads(threads):
    return threads or min(8, os.cpu_count() or 1)


def _checked(base, offsets, lens, row_elems, demo_idx, t_idx, stack, out, dtype):
    """Validate what the C code trusts: dtypes, C order, the demo indices
    and the sizes of the source rows and the output."""
    for name, a, dt in (("base", base, dtype), ("out", out, dtype), ("offsets", offsets, np.int64),
                        ("lens", lens, np.int64), ("demo_idx", demo_idx, np.int64),
                        ("t_idx", t_idx, np.int64)):
        if a.dtype != dt or not a.flags.c_contiguous:
            raise ValueError(f"native gather: {name} must be C-contiguous {np.dtype(dt).name}")
    n = len(demo_idx)
    if len(t_idx) != n or len(offsets) != len(lens):
        raise ValueError("native gather: index arrays disagree in length")
    if n and (demo_idx.min() < 0 or demo_idx.max() >= len(lens)):
        raise ValueError("native gather: demo index out of range")
    if len(lens) and (offsets + lens).max() * row_elems > base.size:
        raise ValueError("native gather: episodes run past the source buffer")
    if out.size != n * stack * row_elems:
        raise ValueError(f"native gather: out holds {out.size} elements, want {n * stack * row_elems}")


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def gather_windows_u8(base, offsets, lens, row_elems, demo_idx, t_idx, stack, out, threads=None):
    """out[i, s] = base row offsets[d] + clamp(t - (stack-1-s), 0, len-1) of
    sample i's episode d and step t, for uint8 rows of ``row_elems``."""
    _checked(base, offsets, lens, row_elems, demo_idx, t_idx, stack, out, np.uint8)
    load().gather_windows_u8(_ptr(base), _p64(offsets), _p64(lens), row_elems, _p64(demo_idx),
                             _p64(t_idx), len(demo_idx), stack, _ptr(out), _threads(threads))


def gather_windows_f32(base, offsets, lens, row_elems, demo_idx, t_idx, stack, out, threads=None):
    """``gather_windows_u8`` for float32 rows (the gaze windows)."""
    _checked(base, offsets, lens, row_elems, demo_idx, t_idx, stack, out, np.float32)
    load().gather_windows_f32(_ptr(base), _p64(offsets), _p64(lens), row_elems, _p64(demo_idx),
                              _p64(t_idx), len(demo_idx), stack, _ptr(out), _threads(threads))


def gather_rows_f32(base, offsets, lens, row_elems, demo_idx, t_idx, out, threads=None):
    """One float32 row a sample, at its step t (the actions)."""
    _checked(base, offsets, lens, row_elems, demo_idx, t_idx, 1, out, np.float32)
    load().gather_rows_f32(_ptr(base), _p64(offsets), _p64(lens), row_elems, _p64(demo_idx),
                           _p64(t_idx), len(demo_idx), _ptr(out), _threads(threads))
