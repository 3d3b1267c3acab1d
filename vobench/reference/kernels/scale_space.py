"""Scale-space construction: DoG + gradient via chained box filters
(PyTorch counterpart of rebvo_tpu/kernels/scale_space.py, the
non-fused twin used when `UsePallas=0`).

Reproduces the reference's iimage/iigauss/sspace stack
(src/mtracklib/iimage.cpp, iigauss.cpp, sspace.cpp): a Gaussian of
deviation sigma is `box_n` successive clipped, normalised box filters
(Kovesi's widths), the DoG is the difference of two such pyramids and the
gradient the central difference of the sigma0 image. Each box pass is two
1-D prefix-sum filters, as in the JAX twin.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def kovesi_box_sizes(sigma: float, box_n: int) -> Tuple[List[int], float]:
    """Box widths approximating a Gaussian of deviation `sigma`
    (iigauss.cpp:43-80); returns the widths and the achieved sigma_r."""
    wideal = math.sqrt(12.0 * sigma * sigma / box_n + 1.0)
    wl = int(wideal)
    if wl % 2 == 0:
        wl -= 1
    wl = max(wl, 1)
    m = round((3 * box_n + 4 * box_n * wl + box_n * wl * wl
               - 12 * sigma * sigma) / (4 + 4 * wl))
    m = min(max(m, 0), box_n)
    sizes = [wl] * m + [wl + 2] * (box_n - m)
    sigma_r = math.sqrt((m * wl * wl + (box_n - m) * (wl + 2.0) ** 2
                         - box_n) / 12.0)
    return sizes, sigma_r


def scale_space_plan(sigma0: float, k_sigma: float, box_n: int = 3):
    """Static filter plan: the second pyramid's sigma derives from the
    first's achieved sigma_r (sspace ctor, sspace.cpp:38-46)."""
    sizes0, sigma_r0 = kovesi_box_sizes(sigma0, box_n)
    sizes1, sigma_r1 = kovesi_box_sizes(sigma_r0 * k_sigma, box_n)
    return sizes0, sizes1, sigma_r0, sigma_r1


def _box_1d(x: Tensor, d: int, dim: int) -> Tuple[Tensor, Tensor]:
    """Clipped 1-D box sum of odd width d along `dim`, plus the per-pixel
    window count (the reference's divisor image, iimage.cpp:86-180)."""
    if d <= 1:
        return x, torch.ones_like(x)
    n = x.shape[dim]
    d2 = d // 2
    c = torch.cumsum(x, dim=dim)
    c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
    idx = torch.arange(n, device=x.device)
    hi = torch.clamp(idx + d2 + 1, max=n)
    lo = torch.clamp(idx - d2, min=0)
    s = torch.index_select(c, dim, hi) - torch.index_select(c, dim, lo)
    count = (hi - lo).to(x.dtype)
    shape = [1] * x.ndim
    shape[dim] = n
    return s, count.reshape(shape)


def box_filter(img: Tensor, d: int) -> Tensor:
    """Normalised clipped 2-D box filter of odd width d (iimage::average)."""
    sy, cy = _box_1d(img, d, dim=-2)
    sxy, cx = _box_1d(sy, d, dim=-1)
    return sxy / (cy * cx)


def gaussian_smooth(img: Tensor, sizes: List[int]) -> Tensor:
    """Chain of box filters (iigauss::smooth, iigauss.cpp:91-103)."""
    out = img
    for d in sizes:
        out = box_filter(out, d)
    return out


class ScaleSpace(NamedTuple):
    img0: Tensor   # sigma0-smoothed image
    img1: Tensor   # sigma0*k-smoothed image
    dog: Tensor    # img1 - img0 (sspace.cpp:63-70)
    dx: Tensor     # central-difference gradient of img0 (sspace.cpp:75-85)
    dy: Tensor


def build_scale_space(img: Tensor, sigma0: float, k_sigma: float,
                      box_n: int = 3) -> ScaleSpace:
    """Full scale-space build (sspace::build, sspace.cpp:52-60) of a
    [..., H, W] image; integer inputs are promoted to float32 first."""
    if not torch.is_floating_point(img):
        img = img.to(torch.float32)
    sizes0, sizes1, _, _ = scale_space_plan(sigma0, k_sigma, box_n)
    img0 = gaussian_smooth(img, sizes0)
    img1 = gaussian_smooth(img, sizes1)
    dog = img1 - img0
    # central differences, zero on the 1-pixel border
    dx = F.pad(img0[..., 1:-1, 2:] - img0[..., 1:-1, :-2], (1, 1, 1, 1))
    dy = F.pad(img0[..., 2:, 1:-1] - img0[..., :-2, 1:-1], (1, 1, 1, 1))
    return ScaleSpace(img0=img0, img1=img1, dog=dog, dx=dx, dy=dy)
