"""Lower-precision arithmetic for the controls of the output check.

``Lowered(fmt)`` is a dispatch mode: inside it every convolution and
matrix product (forward and backward, as autograd runs them) takes its
float32 operands rounded to ``fmt`` and accumulates in float32, which is
what tensor cores do in that format, and its result is stored in
``fmt`` too. ``round_to(x, fmt)`` rounds one tensor.

Formats: ``bf16``; ``fp8`` (e4m3, one scale a tensor: its largest
magnitude maps to 448, as per-tensor scaled fp8 recipes do).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

FORMATS = ("bf16", "fp8")
FP8_MAX = 448.0

_aten = torch.ops.aten
PRODUCTS = {_aten.convolution.default, _aten.convolution_backward.default, _aten.mm.default,
            _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default}


def round_to(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` (float32) rounded to ``fmt``, returned in float32."""
    if fmt == "bf16":
        return x.to(torch.bfloat16).float()
    if fmt == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown format {fmt!r}; expected one of {FORMATS}")


class Lowered(TorchDispatchMode):
    """Every convolution and matrix product inside takes its float32
    operands rounded to ``fmt`` and stores its result in ``fmt``."""

    def __init__(self, fmt: str):
        super().__init__()
        if fmt not in FORMATS:
            raise ValueError(f"unknown format {fmt!r}; expected one of {FORMATS}")
        self.fmt = fmt

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in PRODUCTS:
            return func(*args, **(kwargs or {}))

        def low(a):
            if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
                return round_to(a, self.fmt)
            return a

        return tree_map(low, func(*tree_map(low, args), **(kwargs or {})))
