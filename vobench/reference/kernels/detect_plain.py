"""K1's arithmetic in plain PyTorch: the fused detector (frame ->
detector candidates) and the scale space under it, in the operation
order of the measured program's CUDA kernel, copied from the program's
plain versions (rebvo_tpu_torch/kernels/cuda_scale_space.py).
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

from vobench.reference.core.numerics import div_const
from vobench.reference.kernels.edge_detect import EdgeCandidates
from vobench.reference.kernels.scale_space import ScaleSpace, scale_space_plan

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Plain PyTorch version (the Pallas kernel's exact operation order)
# ---------------------------------------------------------------------------


def _up(x: Tensor, k: int, dim: int) -> Tensor:
    """x[i + k] along `dim`, zero past the end."""
    n = x.shape[dim]
    pad = [0, 0] * (x.ndim - 1 - (dim % x.ndim)) + [0, k]
    return F.pad(x.narrow(dim, k, n - k), pad)


def _down(x: Tensor, k: int, dim: int) -> Tensor:
    """x[i - k] along `dim`, zero before the start."""
    n = x.shape[dim]
    pad = [0, 0] * (x.ndim - 1 - (dim % x.ndim)) + [k, 0]
    return F.pad(x.narrow(dim, 0, n - k), pad)


def _shift_sum(x: Tensor, r: int, dim: int) -> Tensor:
    """out = x; out += x[i+k]; out += x[i-k] for k = 1..r (zero-padded)."""
    out = x
    for k in range(1, r + 1):
        out = out + _up(x, k, dim)
        out = out + _down(x, k, dim)
    return out


def _shift_wsum(x: Tensor, r: int, dim: int) -> Tensor:
    """out = 0; out += k*x[i+k]; out -= k*x[i-k] for k = 1..r."""
    out = torch.zeros_like(x)
    for k in range(1, r + 1):
        out = out + float(k) * _up(x, k, dim)
        out = out - float(k) * _down(x, k, dim)
    return out


def _inv_count(n: int, d: int, device) -> Tensor:
    d2 = d // 2
    idx = torch.arange(n, dtype=torch.int32, device=device)
    hi = torch.clamp(idx + (d2 + 1), max=n)
    lo = torch.clamp(idx - d2, min=0)
    return 1.0 / (hi - lo).to(torch.float32)


def _box_filter(x: Tensor, d: int) -> Tensor:
    if d <= 1:
        return x
    H, W = x.shape[-2:]
    s = _shift_sum(_shift_sum(x, d // 2, -2), d // 2, -1)
    s = s * _inv_count(H, d, x.device)[:, None]
    return s * _inv_count(W, d, x.device)[None, :]


def build_scale_space_plain(img: Tensor, sigma0: float, k_sigma: float,
                            box_n: int = 3) -> ScaleSpace:
    """K2 in plain PyTorch ops: the five scale-space maps of a [..., H, W]
    image, in the order of the Pallas kernel _sspace_kernel (the sizes1
    chain, the sizes0 chain, the DoG, the gradient of img0 with a zero
    1-pixel border)."""
    img = img.to(torch.float32)
    sizes0, sizes1, _, _ = scale_space_plan(sigma0, k_sigma, box_n)
    H, W = img.shape[-2:]
    x1 = img
    for d in sizes1:
        x1 = _box_filter(x1, d)
    x0 = img
    for d in sizes0:
        x0 = _box_filter(x0, d)
    ii = torch.arange(H, device=img.device)[:, None]
    jj = torch.arange(W, device=img.device)[None, :]
    interior1 = (ii > 0) & (ii < H - 1) & (jj > 0) & (jj < W - 1)
    zero = torch.zeros_like(x0)
    dx = torch.where(interior1, _up(x0, 1, -1) - _down(x0, 1, -1), zero)
    dy = torch.where(interior1, _up(x0, 1, -2) - _down(x0, 1, -2), zero)
    return ScaleSpace(img0=x0, img1=x1, dog=x1 - x0, dx=dx, dy=dy)


def detect_candidates_plain(img: Tensor, grad_thresh, *, sigma0: float,
                            k_sigma: float, box_n: int = 3, win_s: int,
                            per_hist: float, dog_thresh: float,
                            max_img_value: float) -> EdgeCandidates:
    """The fused detector in plain PyTorch ops, [..., H, W] float32.
    `grad_thresh` is a scalar or one threshold per leading batch index."""
    ss = build_scale_space_plain(img, sigma0, k_sigma, box_n)
    dog, dx, dy = ss.dog, ss.dx, ss.dy
    H, W = dog.shape[-2:]
    dev = dog.device
    g = torch.as_tensor(grad_thresh, dtype=torch.float32, device=dev)
    g = g.reshape(g.shape + (1, 1)) * max_img_value
    ii = torch.arange(H, device=dev)[:, None]
    jj = torch.arange(W, device=dev)[None, :]

    win_area = float((2 * win_s + 1) ** 2)
    sum_j2 = float((2 * win_s + 1) *
                   sum(j * j for j in range(-win_s, win_s + 1)))

    t1 = dx * dx + dy * dy >= g * g
    sign = torch.where(dog > 0, 1.0, -1.0).to(torch.float32)
    pn = _shift_sum(_shift_sum(sign, win_s, -2), win_s, -1)
    t2 = torch.abs(pn) <= win_area * per_hist

    theta_x = div_const(_shift_sum(_shift_wsum(dog, win_s, -1), win_s, -2),
                        sum_j2)
    theta_y = div_const(_shift_sum(_shift_wsum(dog, win_s, -2), win_s, -1),
                        sum_j2)
    theta_c = div_const(_shift_sum(_shift_sum(dog, win_s, -2), win_s, -1),
                        win_area)
    n2_m = theta_x * theta_x + theta_y * theta_y
    denom = torch.where(n2_m > 0, n2_m, torch.ones_like(n2_m))
    xs = -theta_x * theta_c / denom
    ys = -theta_y * theta_c / denom

    t3 = (torch.abs(xs) <= 0.5) & (torch.abs(ys) <= 0.5)
    gd = g * dog_thresh
    t4 = n2_m >= gd * gd
    interior = (ii >= win_s) & (ii < H - win_s) & \
        (jj >= win_s) & (jj < W - win_s)
    mask = t1 & t2 & t3 & t4 & interior
    return EdgeCandidates(mask=mask, theta_x=theta_x, theta_y=theta_y,
                          xs=xs, ys=ys, n2_m=n2_m)


