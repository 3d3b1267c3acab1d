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
"""

from __future__ import annotations

import torch

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
