"""Auxiliary match field: nearest-keyline lookup image (PyTorch
counterpart of rebvo_tpu/kernels/field.py; reference
global_tracker::build_field, src/mtracklib/global_tracker.cpp:61-105).

Every keyline paints a +-radius segment along its gradient direction;
the serial paint loop is one scatter-min of packed (distance << 18 |
inverted slot) int32 keys, so the field comes out exactly equal to the
JAX package's.
"""

from __future__ import annotations

import torch

from vobench.reference.core.numerics import floor_int
from vobench.reference.frontend.state import KeylineMap

Tensor = torch.Tensor

_SLOT_BITS = 18          # supports K up to 262144 (> KEYLINE_MAX=50000)
_EMPTY = 2147483647


def build_field(klm: KeylineMap, min_mod: Tensor, *, radius: int,
                height: int, width: int) -> Tensor:
    """Field image [H, W] int32: keyline slot id or -1. `min_mod` gates
    weak keylines out (the re-tuned detector threshold,
    rebvo_second_t.cpp:177)."""
    K = klm.K
    dev = klm.x.device
    ok = klm.valid & (klm.n_m >= min_mod)

    t = torch.arange(-radius, radius, dtype=klm.x.dtype, device=dev)
    # round2int_positive = floor(v + 0.5)
    xi = floor_int(klm.ux[:, None] * t[None, :] + klm.x[:, None] + 0.5)
    yi = floor_int(klm.uy[:, None] * t[None, :] + klm.y[:, None] + 0.5)
    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height) & ok[:, None]

    at = torch.abs(t).to(torch.int32)[None, :]
    # equal-distance ties go to the HIGHER slot id (last writer wins in the
    # reference's paint loop): the slot is stored inverted
    slot = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    key = (at << _SLOT_BITS) | (K - 1 - slot)

    n_pix = height * width
    flat_idx = torch.where(inb, yi * width + xi,
                           torch.full_like(xi, n_pix)).to(torch.int64)
    field = torch.full((n_pix + 1,), _EMPTY, dtype=torch.int32, device=dev)
    field = field.scatter_reduce(0, flat_idx.reshape(-1), key.reshape(-1),
                                 reduce="amin", include_self=True)[:n_pix]
    ikl = torch.where(field == _EMPTY, torch.full_like(field, -1),
                      K - 1 - (field & ((1 << _SLOT_BITS) - 1)))
    return ikl.reshape(height, width)
