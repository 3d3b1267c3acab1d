"""Numeric helpers that pin PyTorch to the JAX reference's semantics.

* `to_int32` — XLA's float -> int32 conversion is defined everywhere:
  truncation toward zero, NaN -> 0, out-of-range saturates to the int32
  limits. `Tensor.to(torch.int32)` is undefined for NaN / out-of-range
  values on the CPU (it gives INT_MIN) and differs again on CUDA, and
  those values do reach the conversions (a keyline projected through a
  degenerate pose), so every float -> int site goes through here.
* `div_const` — true division by a Python constant. On CUDA, PyTorch
  turns `x / c` with a Python scalar `c` into `x * (1/c)`, which rounds
  differently from the reference's division; dividing by a 0-d device
  tensor keeps it a true division on every device.
* `matmul` and `sum64` — products and long sums accumulated in float64
  and rounded once to float32. A float32 sum in another order (the
  card's against the CPU's, or a vmapped batch's against one lane's)
  rounds differently, and the step's discrete tests (the LM's accept
  test and rung choice, a keyline's search window) amplify that into
  another trajectory; rounded from float64, both get the same float32
  value but near a tie. On the CPU, `@` of one lane is an mm and of a
  vmapped batch a bmm, whose BLAS paths differ, so there `matmul` is a
  broadcast multiply summed over the shared axis, which reduces in the
  same order with or without leading batch axes: a vmapped lane equals
  the lane alone bit for bit (`torch.linalg.vecdot`, which is that
  multiply and sum). CUDA tensors take `@` (in float64).
* `reversed_sums` — within it, `matmul` and `sum64` add in another
  order (the summed axis reversed): what a sound change that reorders
  those sums computes, for the benchmark's readings.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_REVERSED = [False]


@contextmanager
def reversed_sums():
    """`matmul` and `sum64` sum their axis in reverse order inside."""
    _REVERSED[0] = True
    try:
        yield
    finally:
        _REVERSED[0] = False

_I32_MAX = 2147483647
_I32_MIN = -2147483648
_TWO31 = 2147483648.0


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 with XLA semantics (truncate, NaN -> 0, saturate)."""
    hi = x >= _TWO31
    lo = x <= -_TWO31
    safe = torch.where(torch.isnan(x) | hi | lo, torch.zeros_like(x), x)
    out = safe.to(torch.int32)
    out = torch.where(hi, torch.full_like(out, _I32_MAX), out)
    return torch.where(lo, torch.full_like(out, _I32_MIN), out)


def floor_int(x: torch.Tensor) -> torch.Tensor:
    """`floor(x).astype(int32)` of the reference."""
    return to_int32(torch.floor(x))


def round_int(x: torch.Tensor) -> torch.Tensor:
    """`floor(x + 0.5).astype(int32)` (the reference's round2int)."""
    return to_int32(torch.floor(x + 0.5))


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division on every device (see module note)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` (matrices [..., n, k] @ [..., k, m], or a vector on
    either side) accumulated in float64, in `a`'s dtype; batch-invariant
    on the CPU (see module note)."""
    dt = a.dtype
    a, b = a.double(), b.double()
    if _REVERSED[0]:
        a, b = a.flip(-1), b.flip(-2 if b.ndim >= 2 else -1)
    if a.device.type != "cpu":
        return (a @ b).to(dt)
    if b.ndim == 1:
        return torch.linalg.vecdot(a, b).to(dt)
    if a.ndim == 1:
        return torch.linalg.vecdot(a[:, None], b, dim=-2).to(dt)
    return torch.linalg.vecdot(a[..., :, :, None], b[..., None, :, :],
                               dim=-2).to(dt)


def sum64(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Sum (over `dim`, default all) accumulated in float64, in x's
    dtype (see module note)."""
    if _REVERSED[0]:
        if dim is None:
            x, dim = x.flatten(), 0
        dims = dim if isinstance(dim, (tuple, list)) else (dim,)
        return torch.sum(x.flip(tuple(dims)), dim=dim,
                         dtype=torch.float64).to(x.dtype)
    if dim is None:
        return torch.sum(x, dtype=torch.float64).to(x.dtype)
    return torch.sum(x, dim=dim, dtype=torch.float64).to(x.dtype)
