"""nvcc builds of the port's CUDA kernels (csrc/*.cu).

Each source compiles for sm_90a into a shared library with a plain C
interface under ``gabril_carla_tpu_torch/_build/`` at first use, named by
the source's stem and keyed by the hash of its bytes and the flags, and is
loaded with ctypes by its wrapper module (ops/render_kernel.py,
ops/threefry_kernel.py). A failed build raises with nvcc's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build(source: Path, flags=NVCC_FLAGS) -> tuple[Path, str]:
    """Compile ``source`` with nvcc unless a library built from the same
    source and flags exists. Returns (library path, compiler output; empty
    when nothing was compiled)."""
    source = Path(source)
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"nvcc could not run on {source}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr
