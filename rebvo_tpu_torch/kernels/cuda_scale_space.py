"""The scale-space kernels and their plain PyTorch versions (counterpart
of rebvo_tpu/kernels/pallas_scale_space.py):

* K1, `detect_candidates_cuda`: fused frame -> detector candidates, the
  entry the step calls (`csrc/detect_candidates.cu`). It returns the same
  EdgeCandidates as
  kernels.edge_detect.detect_candidates(build_scale_space(img), ...).
* K2, `build_scale_space_cuda`: frame -> the five scale-space maps
  (`csrc/build_scale_space.cu`), used by `profiling.stage_breakdown`.

For a CUDA tensor each wrapper launches its kernel (built by `nvcc` at
first use) or raises; for a CPU tensor it runs its plain version, which
repeats the kernel's arithmetic in the Pallas kernels' shift-and-add
order. There is no fallback from the card to the plain version. Each
wrapper counts its launches in `.launches`; `WRAPPERS` lists them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import torch
import torch.nn.functional as F

from rebvo_tpu_torch.core.numerics import div_const
from rebvo_tpu_torch.kernels import cuda_build
from rebvo_tpu_torch.kernels.edge_detect import EdgeCandidates
from rebvo_tpu_torch.kernels.scale_space import ScaleSpace, scale_space_plan

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


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_image(who: str, img: Tensor) -> None:
    if img.dtype != torch.float32:
        raise TypeError(f"{who}: img must be float32, got {img.dtype}")
    if img.ndim < 2:
        raise ValueError(f"{who}: img must be [..., H, W], got shape "
                         f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError(f"{who}: img must be contiguous")


def _batch(img: Tensor) -> int:
    B = 1
    for n in img.shape[:-2]:
        B *= n
    return B


def detect_halo(sizes0: List[int], sizes1: List[int], win_s: int) -> int:
    """Tile halo the kernel needs: the DoG window reaches win_s past the
    output, and the DoG needs both box chains' radii; the gradient needs
    img0 one pixel out."""
    r0 = sum(d // 2 for d in sizes0)
    r1 = sum(d // 2 for d in sizes1)
    return max(r0 + 1, max(r0, r1) + win_s)


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    fn = cuda_build.library("detect_candidates").detect_candidates_launch
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, P, I, P, I, I, I,
                   Fl, Fl, Fl, Fl, Fl, P]
    fn.restype = ctypes.c_int
    return fn


def detect_candidates_cuda(img: Tensor, grad_thresh, *, sigma0: float,
                           k_sigma: float, box_n: int = 3, win_s: int,
                           per_hist: float, dog_thresh: float,
                           max_img_value: float) -> EdgeCandidates:
    """Fused frame -> EdgeCandidates. `img` is [..., H, W] float32 and
    contiguous; `grad_thresh` a tensor on the same device (scalar, or one
    value per leading batch index), read by the kernel on the device.
    A CPU `img` runs the plain version; a CUDA `img` launches the kernel.
    Each launch adds one to `detect_candidates_cuda.launches`."""
    if img.device.type == "cpu":
        return detect_candidates_plain(
            img, grad_thresh, sigma0=sigma0, k_sigma=k_sigma, box_n=box_n,
            win_s=win_s, per_hist=per_hist, dog_thresh=dog_thresh,
            max_img_value=max_img_value)
    if img.device.type != "cuda":
        raise ValueError(f"detect_candidates_cuda: unsupported device "
                         f"{img.device}")
    _check_image("detect_candidates_cuda", img)
    if not (isinstance(grad_thresh, Tensor)
            and grad_thresh.device == img.device
            and grad_thresh.dtype == torch.float32):
        raise TypeError("detect_candidates_cuda: grad_thresh must be a "
                        "float32 tensor on the image's device")
    batch = img.shape[:-2]
    H, W = img.shape[-2:]
    B = _batch(img)
    thresh = grad_thresh.expand(batch).contiguous().reshape(B)
    sizes0, sizes1, _, _ = scale_space_plan(sigma0, k_sigma, box_n)
    halo = detect_halo(sizes0, sizes1, win_s)

    mask = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    outs = [torch.empty(img.shape, dtype=torch.float32, device=img.device)
            for _ in range(5)]
    s0 = (ctypes.c_int * len(sizes0))(*sizes0)
    s1 = (ctypes.c_int * len(sizes1))(*sizes1)
    win_area = float((2 * win_s + 1) ** 2)
    sum_j2 = float((2 * win_s + 1) *
                   sum(j * j for j in range(-win_s, win_s + 1)))
    if B > 0 and H > 0 and W > 0:
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _launcher()(img.data_ptr(), thresh.data_ptr(), mask.data_ptr(),
                 *[o.data_ptr() for o in outs], B, H, W,
                 s0, len(sizes0), s1, len(sizes1), halo, win_s,
                 win_area * per_hist, max_img_value, dog_thresh, sum_j2,
                 win_area, stream)
        if err != 0:
            raise RuntimeError(f"detect_candidates kernel launch failed: "
                               f"cudaError {err}")
        detect_candidates_cuda.launches += 1
    return EdgeCandidates(mask=mask, theta_x=outs[0], theta_y=outs[1],
                          xs=outs[2], ys=outs[3], n2_m=outs[4])


detect_candidates_cuda.launches = 0


def sspace_halo(sizes0: List[int], sizes1: List[int]) -> int:
    """Tile halo K2 needs: img1 needs the sizes1 chain's radius, img0 the
    sizes0 chain's radius plus one pixel for its gradient."""
    r0 = sum(d // 2 for d in sizes0)
    r1 = sum(d // 2 for d in sizes1)
    return max(r0 + 1, r1)


@functools.cache
def _sspace_launcher():
    """K2's C entry point, built and loaded at first use."""
    fn = cuda_build.library("build_scale_space").build_scale_space_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, I, I, P, I, P, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def build_scale_space_cuda(img: Tensor, sigma0: float, k_sigma: float,
                           box_n: int = 3) -> ScaleSpace:
    """Frame -> ScaleSpace (img0, img1, dog, dx, dy), the counterpart of
    build_scale_space_pallas. `img` is [..., H, W] float32 and contiguous
    on any device. A CPU `img` runs the plain version; a CUDA `img`
    launches K2. Each launch adds one to `build_scale_space_cuda.launches`."""
    _check_image("build_scale_space_cuda", img)
    if img.device.type == "cpu":
        return build_scale_space_plain(img, sigma0, k_sigma, box_n)
    if img.device.type != "cuda":
        raise ValueError(f"build_scale_space_cuda: unsupported device "
                         f"{img.device}")
    B = _batch(img)
    H, W = img.shape[-2:]
    sizes0, sizes1, _, _ = scale_space_plan(sigma0, k_sigma, box_n)
    outs = [torch.empty(img.shape, dtype=torch.float32, device=img.device)
            for _ in range(5)]
    if B > 0 and H > 0 and W > 0:
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _sspace_launcher()(
            img.data_ptr(), *[o.data_ptr() for o in outs], B, H, W,
            (ctypes.c_int * len(sizes0))(*sizes0), len(sizes0),
            (ctypes.c_int * len(sizes1))(*sizes1), len(sizes1),
            sspace_halo(sizes0, sizes1), stream)
        if err != 0:
            raise RuntimeError(f"build_scale_space kernel launch failed: "
                               f"cudaError {err}")
        build_scale_space_cuda.launches += 1
    return ScaleSpace(*outs)


build_scale_space_cuda.launches = 0

# every kernel wrapper of this module (each counts its launches)
WRAPPERS = (detect_candidates_cuda, build_scale_space_cuda)
