"""Small statistics utilities (PyTorch counterpart of
rebvo_tpu/core/stats.py; reference NormalDistribution,
include/UtilLib/NormalDistribution.h:30-150)."""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

_INV_SQRT_2PI = 0.3989422804014327


def normal_pdf(x: Tensor, mu: Tensor, sigma: Tensor) -> Tensor:
    """Gaussian pdf (eval(), NormalDistribution.h:56-66)."""
    z = (x - mu) / sigma
    return _INV_SQRT_2PI * torch.exp(-0.5 * z * z) / sigma


def eval_reciprocal(mean: Tensor, dev: Tensor, r: float = 1.0,
                    n: int = 10) -> Tuple[Tensor, Tensor]:
    """Moment-matched distribution of 1/X for X ~ N(mean, dev)
    (EvalReciprocal, NormalDistribution.h:69-140); grid points at exactly
    zero are masked out. Broadcasts over leading axes."""
    mean = torch.as_tensor(mean)
    dev = torch.as_tensor(dev, dtype=mean.dtype, device=mean.device)
    i = torch.arange(n, dtype=mean.dtype, device=mean.device)
    x = 2.0 * dev[..., None] * r * (i - n // 2) / (n - 1.0) + mean[..., None]
    p = normal_pdf(x, mean[..., None], dev[..., None])
    nonzero = torch.abs(x) > 0
    zero = torch.zeros_like(p)
    p = torch.where(nonzero, p, zero)
    rx = torch.where(nonzero, 1.0 / torch.where(nonzero, x, torch.ones_like(x)),
                     zero)
    mass = torch.sum(p, dim=-1)
    mass = torch.where(mass > 0, mass, torch.ones_like(mass))
    mr = torch.sum(rx * p, dim=-1) / mass
    vr = torch.sum(torch.square(rx - mr[..., None]) * p, dim=-1) / mass
    return mr, torch.sqrt(vr)


def masked_median(x: Tensor, mask: Tensor, fallback: float = 1.0) -> Tensor:
    """Median of x where mask, via one sort (fixed shapes, no host sync);
    `fallback` when nothing is masked in."""
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))),
                    dim=-1).values
    cnt = torch.sum(mask, dim=-1).to(torch.int64)
    idx = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"),
                      0, x.shape[-1] - 1)
    med = torch.gather(xs, -1, idx[..., None])[..., 0]
    return torch.where(cnt > 0, med, torch.full_like(med, fallback))
