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
wrapper counts its launches in `.launches` (`kernels/registry.WRAPPERS`
lists every kernel wrapper).

Both kernels run one tile pipeline (`csrc/tile_pipeline.cuh`);
`launch_plan` is the pure function that picks its instantiation (the
compiled-in default plan, or the plan read at run time), halo, radii,
margins and grid, and raises for a plan the kernels cannot run. The C
launchers take that plan and grid and only check them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# Launch plan of the tile pipeline (csrc/tile_pipeline.cuh)
# ---------------------------------------------------------------------------

# The C launchers check a plan and a grid against these (OH, OW, HP,
# MAX_BOXES of tile_pipeline.cuh) and refuse what does not fit.
TILE = (30, 48)              # output rows, columns of a block (OH, OW)
MAX_HALO = 8                 # the buffers' pad (HP)
MAX_BOXES = 4                # boxes per chain

# the plans compiled in as constants: (sizes0, sizes1, win_s) of the
# default configuration (Sigma0 = 1.7818, KSigma = 1.2599, box_n = 3,
# DetectorPlaneFitSize = 2)
FIXED_PLANS = {"detect_candidates": ([3, 3, 5], [3, 5, 5], 2),
               "build_scale_space": ([3, 3, 5], [3, 5, 5], 0)}


@dataclass(frozen=True)
class LaunchPlan:
    kernel: str
    fixed: bool                  # True: the default plan's instantiation
    halo: int                    # tile halo, <= MAX_HALO
    radii: Tuple[Tuple[int, ...], Tuple[int, ...]]   # per chain, widths > 1
    margins: Tuple[int, int]     # pixels past the tile each chain ends at
    win_s: int
    tile: Tuple[int, int]
    grid: Tuple[int, int, int]   # (column tiles, row tiles, batch)

    def c_args(self) -> list:
        """The plan as the C launchers take it: gx, gy, halo, [win_s,]
        e0, e1, r0, n0, r1, n1, fixed."""
        r0, r1 = ((ctypes.c_int * len(r))(*r) for r in self.radii)
        w = [self.win_s] if self.kernel == "detect_candidates" else []
        return [*self.grid[:2], self.halo, *w, *self.margins,
                r0, len(self.radii[0]), r1, len(self.radii[1]),
                int(self.fixed)]


def _chains(kernel: str, sizes0: Sequence[int], sizes1: Sequence[int],
            win_s: int):
    """(win_s, margins, radii, halo) of `kernel`'s two chains."""
    if kernel not in FIXED_PLANS:
        raise ValueError(f"unknown kernel {kernel!r}")
    w = win_s if kernel == "detect_candidates" else 0
    margins = ((max(w, 1), w) if kernel == "detect_candidates"
               else (1, 0))
    radii = tuple(tuple(d // 2 for d in sz if d > 1)
                  for sz in (sizes0, sizes1))
    return w, margins, radii, max(m + sum(r) for m, r in zip(margins, radii))


def launch_plan(kernel: str, batch: int, H: int, W: int,
                sizes0: Sequence[int], sizes1: Sequence[int],
                win_s: int = 0) -> LaunchPlan:
    """How `kernel` ("detect_candidates" or "build_scale_space") runs
    the box chains `sizes0` (img0) and `sizes1` (img1) on a [batch, H, W]
    frame. Each chain's passes shrink the band they cover by their radius
    down to the chain's margin: K1 needs img0 max(win_s, 1) pixels past
    the tile (the DoG window, the gradient) and img1 win_s (the DoG
    window), K2 img0 one pixel (the gradient) and img1 none. Raises
    ValueError for more than MAX_BOXES boxes or a halo over MAX_HALO,
    which the kernels cannot run."""
    if len(sizes0) > MAX_BOXES or len(sizes1) > MAX_BOXES:
        raise ValueError(f"launch_plan: at most {MAX_BOXES} boxes per "
                         f"chain, got {list(sizes0)} and {list(sizes1)}")
    w, margins, radii, halo = _chains(kernel, sizes0, sizes1, win_s)
    if halo > MAX_HALO:
        raise ValueError(f"launch_plan: {kernel} needs a halo of {halo} "
                         f"pixels, the kernels hold at most {MAX_HALO}")
    fixed = (list(sizes0), list(sizes1), w) == FIXED_PLANS[kernel]
    grid = (-(-W // TILE[1]), -(-H // TILE[0]), batch)
    return LaunchPlan(kernel, fixed, halo, radii, margins, w, TILE, grid)


def detect_halo(sizes0: List[int], sizes1: List[int], win_s: int) -> int:
    """Tile halo K1 needs: the DoG window reaches win_s past the output
    (the gradient 1), and the DoG needs both box chains' radii."""
    return _chains("detect_candidates", sizes0, sizes1, win_s)[3]


@functools.cache
def _load(name: str):
    """`name`'s library, built and loaded at first use, after its init
    (which grants the kernels their dynamic shared memory) has run."""
    lib = cuda_build.library(name)
    init = getattr(lib, f"{name}_init")
    init.restype = ctypes.c_int
    err = init()
    if err != 0:
        raise RuntimeError(f"{name}_init failed: cudaError {err}")
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# detect_candidates_launch: img, thresh, mask, 5 maps; B, H, W; the plan
# (LaunchPlan.c_args); pn_limit, max_img_value, dog_thresh, sum_j2,
# win_area; stream
K1_ARGTYPES = ([_P] * 8 + [_I] * 3 + [_I] * 6 + [_P, _I, _P, _I, _I] +
               [_F] * 5 + [_P])
# build_scale_space_launch: img, 5 maps; B, H, W; the plan; stream
K2_ARGTYPES = [_P] * 6 + [_I] * 3 + [_I] * 5 + [_P, _I, _P, _I, _I] + [_P]


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _load("detect_candidates").detect_candidates_launch
    fn.argtypes = K1_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def detect_launch(launch: Callable[..., int], img: Tensor, grad_thresh: Tensor,
                  stream, *, sigma0: float, k_sigma: float, box_n: int = 3,
                  win_s: int, per_hist: float, dog_thresh: float,
                  max_img_value: float) -> EdgeCandidates:
    """K1 on `img` through the C entry point `launch` (argument types
    K1_ARGTYPES): the launch plan, the outputs, the launch. Returns the
    candidates; raises if the launcher refuses. `detect_candidates_cuda`
    passes the card's entry point; the tests a host build of the same
    source."""
    batch = img.shape[:-2]
    H, W = img.shape[-2:]
    B = _batch(img)
    thresh = grad_thresh.expand(batch).contiguous().reshape(B)
    sizes0, sizes1, _, _ = scale_space_plan(sigma0, k_sigma, box_n)
    plan = launch_plan("detect_candidates", B, H, W, sizes0, sizes1, win_s)
    mask = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    outs = [torch.empty(img.shape, dtype=torch.float32, device=img.device)
            for _ in range(5)]
    win_area = float((2 * win_s + 1) ** 2)
    sum_j2 = float((2 * win_s + 1) *
                   sum(j * j for j in range(-win_s, win_s + 1)))
    if B > 0 and H > 0 and W > 0:
        err = launch(img.data_ptr(), thresh.data_ptr(), mask.data_ptr(),
                     *[o.data_ptr() for o in outs], B, H, W, *plan.c_args(),
                     win_area * per_hist, max_img_value, dog_thresh, sum_j2,
                     win_area, stream)
        if err != 0:
            raise RuntimeError(f"detect_candidates kernel launch failed: "
                               f"cudaError {err}")
    return EdgeCandidates(mask=mask, theta_x=outs[0], theta_y=outs[1],
                          xs=outs[2], ys=outs[3], n2_m=outs[4])


def detect_candidates_cuda(img: Tensor, grad_thresh, *, sigma0: float,
                           k_sigma: float, box_n: int = 3, win_s: int,
                           per_hist: float, dog_thresh: float,
                           max_img_value: float) -> EdgeCandidates:
    """Fused frame -> EdgeCandidates. `img` is [..., H, W] float32 and
    contiguous; `grad_thresh` a tensor on the same device (scalar, or one
    value per leading batch index), read by the kernel on the device.
    A CPU `img` runs the plain version; a CUDA `img` launches the kernel.
    Each launch adds one to `detect_candidates_cuda.launches`.

    The call goes through the custom op `rebvo_tpu_torch::
    detect_candidates`, whose vmap rule hands the frames of every vmapped
    lane to one call: under `torch.func.vmap` K1 launches once over
    [B, ..., H, W] with one threshold per frame (the plain version runs
    on a CPU batch alike), and `.launches` counts that launch once."""
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"detect_candidates_cuda: unsupported device "
                         f"{img.device}")
    if img.device.type == "cpu" and not isinstance(grad_thresh, Tensor):
        grad_thresh = torch.as_tensor(grad_thresh, dtype=torch.float32)
    if not (isinstance(grad_thresh, Tensor)
            and grad_thresh.device == img.device
            and grad_thresh.dtype == torch.float32):
        if img.device.type == "cuda":
            raise TypeError("detect_candidates_cuda: grad_thresh must be a "
                            "float32 tensor on the image's device")
        grad_thresh = grad_thresh.to(device=img.device, dtype=torch.float32)
    out = _detect_op(img, grad_thresh, float(sigma0), float(k_sigma),
                     int(box_n), int(win_s), float(per_hist),
                     float(dog_thresh), float(max_img_value))
    return EdgeCandidates(*out)


detect_candidates_cuda.launches = 0


@torch.library.custom_op("rebvo_tpu_torch::detect_candidates",
                         mutates_args=())
def _detect_op(img: Tensor, grad_thresh: Tensor, sigma0: float,
               k_sigma: float, box_n: int, win_s: int, per_hist: float,
               dog_thresh: float, max_img_value: float
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """K1 on the CUDA device, its plain version on the CPU: (mask,
    theta_x, theta_y, xs, ys, n2_m)."""
    kw = dict(sigma0=sigma0, k_sigma=k_sigma, box_n=box_n, win_s=win_s,
              per_hist=per_hist, dog_thresh=dog_thresh,
              max_img_value=max_img_value)
    if img.device.type == "cpu":
        return tuple(detect_candidates_plain(img, grad_thresh, **kw))
    _check_image("detect_candidates_cuda", img)
    cand = detect_launch(
        _launcher(), img, grad_thresh,
        torch.cuda.current_stream(img.device).cuda_stream, **kw)
    if img.numel() > 0:
        detect_candidates_cuda.launches += 1
    return tuple(cand)


@_detect_op.register_fake
def _detect_fake(img, grad_thresh, *cfg):
    return (torch.empty_like(img, dtype=torch.bool),) + tuple(
        torch.empty_like(img, dtype=torch.float32) for _ in range(5))


def _detect_vmap(info, in_dims, img, grad_thresh, *cfg):
    """vmap rule of K1: the lanes' frames [B, ..., H, W] in one call, each
    frame with its lane's threshold."""
    B = info.batch_size
    img_dim, th_dim = in_dims[:2]
    img = (img.movedim(img_dim, 0) if img_dim is not None
           else img.expand((B,) + img.shape))
    lane = img.shape[1:-2]
    if th_dim is not None:
        th = grad_thresh.movedim(th_dim, 0)
        grad_thresh = th.reshape((B,) + (1,) * (len(lane) - th.ndim + 1) +
                                 th.shape[1:])
    grad_thresh = grad_thresh.expand((B,) + lane)
    out = _detect_op(img.contiguous(), grad_thresh.contiguous(), *cfg)
    return out, (0,) * len(out)


torch.library.register_vmap("rebvo_tpu_torch::detect_candidates",
                            _detect_vmap)


def sspace_halo(sizes0: List[int], sizes1: List[int]) -> int:
    """Tile halo K2 needs: img1 needs the sizes1 chain's radius, img0 the
    sizes0 chain's radius plus one pixel for its gradient."""
    return _chains("build_scale_space", sizes0, sizes1, 0)[3]


@functools.cache
def _sspace_launcher():
    """K2's C entry point, built and loaded at first use."""
    fn = _load("build_scale_space").build_scale_space_launch
    fn.argtypes = K2_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def sspace_launch(launch: Callable[..., int], img: Tensor, stream,
                  sigma0: float, k_sigma: float,
                  box_n: int = 3) -> ScaleSpace:
    """K2 on `img` through the C entry point `launch` (argument types
    K2_ARGTYPES), as `detect_launch` for K1."""
    B = _batch(img)
    H, W = img.shape[-2:]
    sizes0, sizes1, _, _ = scale_space_plan(sigma0, k_sigma, box_n)
    plan = launch_plan("build_scale_space", B, H, W, sizes0, sizes1)
    outs = [torch.empty(img.shape, dtype=torch.float32, device=img.device)
            for _ in range(5)]
    if B > 0 and H > 0 and W > 0:
        err = launch(img.data_ptr(), *[o.data_ptr() for o in outs], B, H, W,
                     *plan.c_args(), stream)
        if err != 0:
            raise RuntimeError(f"build_scale_space kernel launch failed: "
                               f"cudaError {err}")
    return ScaleSpace(*outs)


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
    ss = sspace_launch(_sspace_launcher(), img,
                       torch.cuda.current_stream(img.device).cuda_stream,
                       sigma0, k_sigma, box_n)
    if img.numel() > 0:
        build_scale_space_cuda.launches += 1
    return ss


build_scale_space_cuda.launches = 0


def launch_config(kernel: str) -> Tuple[int, int]:
    """(dynamic shared bytes, threads per block) that `kernel`'s launcher
    passes, read from its library; needs the card."""
    fn = getattr(_load(kernel), f"{kernel}_launch_config")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = None
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    fn(ctypes.byref(smem), ctypes.byref(threads))
    return smem.value, threads.value


def blocks_per_sm(kernel: str, fixed: bool) -> int:
    """Resident blocks per SM of `kernel`'s instantiation (the default
    plan's if `fixed`), from CUDA's occupancy calculator; needs the card."""
    fn = getattr(_load(kernel), f"{kernel}_occupancy")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(ctypes.c_int(int(fixed)), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"{kernel}_occupancy failed: cudaError {err}")
    return n.value

