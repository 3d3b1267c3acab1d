"""Dense depth from sparse edge keylines on a coarse grid (PyTorch
counterpart of rebvo_tpu/kernels/depth_filler.py).

Re-implements the behaviour of depth_filler (reference
src/visualizer/depth_filler.cpp): block-downsampled grid seeded with
information-weighted keyline inverse depths, coarse-to-fine
initialisation of the free cells (InitCoarseFine, depth_filler.cpp:233-
278), then relaxation so free cells interpolate smoothly between the
fixed edge cells — inverse depth AND its uncertainty are both relaxed
(Integrate1Step, depth_filler.cpp:301-357), with the reference's
boundary modes (BOUND_NONE / BOUND_CORNERS / BOUND_FULL,
depth_filler.h:62: boundary cells keep their seeded s_rho).

As in the JAX package, the serial Gauss-Seidel sweep is Jacobi
iterations of a 3x3 neighbour sum (`F.conv2d`, TF32 off package-wide)
under a fixed-cell mask, here a Python loop of tensor ops with no host
read; the coarse-to-fine pass is a power-of-two masked sum pyramid
broadcast back down. The seed's scatter-add (`.at[].add(mode="drop")`
in JAX) is an `index_add_` into one slot more than the grid, the last
slot dropped, accumulated in float64 and rounded once, so the card's
atomic order and the CPU's sequential one round alike. Plain PyTorch:
the reference has no Pallas kernel here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from rebvo_tpu_torch.core.numerics import div_const, to_int32
from rebvo_tpu_torch.frontend.state import KeylineMap

Tensor = torch.Tensor

BOUND_NONE = "none"
BOUND_CORNERS = "corners"
BOUND_FULL = "full"


class DepthFill(NamedTuple):
    rho: Tensor     # [GH, GW] dense inverse depth on the grid
    s_rho: Tensor   # [GH, GW] relaxed uncertainty
    fixed: Tensor   # [GH, GW] bool — cell seeded by keylines
    block: int      # block size (pixels per cell)


def _seed(klm: KeylineMap, gh: int, gw: int, block: int, s_rho_max: float):
    """Information-weighted per-cell mean of keyline inverse depths
    (depth_filler.cpp:59-168)."""
    cx = torch.clamp(to_int32(div_const(klm.x, block)), 0, gw - 1)
    cy = torch.clamp(to_int32(div_const(klm.y, block)), 0, gh - 1)
    use = klm.valid & (klm.s_rho < s_rho_max)
    w = torch.where(use, 1.0 / torch.square(torch.clamp(klm.s_rho,
                                                        min=1e-3)), 0.0)
    idx = torch.where(use, cy * gw + cx, gh * gw).to(torch.int64)
    acc = torch.zeros((2, gh * gw + 1), dtype=torch.float64,
                      device=klm.x.device)
    acc.index_add_(1, idx, torch.stack([w * klm.rho, w]).to(torch.float64))
    num, den = acc[:, :gh * gw].to(klm.rho.dtype)
    fixed = den > 0
    rho = torch.where(fixed, num / torch.where(fixed, den, 1.0), 0.0)
    s = torch.where(fixed, torch.rsqrt(torch.where(fixed, den, 1.0)), 1e3)
    return (rho.reshape(gh, gw), s.reshape(gh, gw), fixed.reshape(gh, gw))


def _boundary_mask(gh: int, gw: int, mode: str, device) -> Tensor:
    """Cells whose s_rho is pinned (inboundary, depth_filler.cpp)."""
    m = torch.zeros((gh, gw), dtype=torch.bool, device=device)
    if mode == BOUND_FULL:
        m[0, :] = True
        m[-1, :] = True
        m[:, 0] = True
        m[:, -1] = True
    elif mode == BOUND_CORNERS:
        m[0, 0] = m[0, -1] = m[-1, 0] = m[-1, -1] = True
    return m


def _coarse_to_fine_init(rho: Tensor, s: Tensor, fixed: Tensor,
                         fill_rho: Tensor) -> Tuple[Tensor, Tensor]:
    """InitCoarseFine (depth_filler.cpp:233-278): free cells take the
    block mean of the fixed cells covering them, from coarse blocks down
    to fine — each finer level refines where it has fixed support.

    A masked sum pyramid on a power-of-two pad: level k sums 2^k x 2^k
    blocks of (fixed ? value : 0) and the fixed count; a free cell takes
    the finest level whose block saw a fixed cell."""
    gh, gw = rho.shape
    ph = 1 << max(1, math.ceil(math.log2(max(gh, 1))))
    pw = 1 << max(1, math.ceil(math.log2(max(gw, 1))))

    f = fixed.to(rho.dtype)
    pad = (0, pw - gw, 0, ph - gh)
    vr = F.pad(rho * f, pad)
    vs = F.pad(s * f, pad)
    vf = F.pad(f, pad)

    out_r = torch.zeros_like(vr)
    out_s = torch.zeros_like(vr)
    have = torch.zeros((ph, pw), dtype=torch.bool, device=rho.device)
    # coarse -> fine: finer levels overwrite where they have support
    n_levels = max(int(math.log2(ph)), int(math.log2(pw))) + 1
    for k in range(n_levels - 1, -1, -1):
        bh, bw = min(1 << k, ph), min(1 << k, pw)
        nh, nw = ph // bh, pw // bw
        cnt = vf.reshape(nh, bh, nw, bw).sum(dim=(1, 3))
        rsum = vr.reshape(nh, bh, nw, bw).sum(dim=(1, 3))
        ssum = vs.reshape(nh, bh, nw, bw).sum(dim=(1, 3))
        has = cnt > 0
        safe = torch.where(has, cnt, 1.0)
        mr = torch.where(has, rsum / safe, 0.0)
        ms = torch.where(has, ssum / safe, 0.0)

        def up(a):
            return a.repeat_interleave(bh, dim=0).repeat_interleave(bw,
                                                                    dim=1)
        has_up = up(has)
        out_r = torch.where(has_up, up(mr), out_r)
        out_s = torch.where(has_up, up(ms), out_s)
        have = have | has_up

    out_r = out_r[:gh, :gw]
    out_s = out_s[:gh, :gw]
    have = have[:gh, :gw]
    rho_init = torch.where(fixed, rho, torch.where(have, out_r, fill_rho))
    s_init = torch.where(fixed, s, torch.where(have, out_s, 1e3))
    return rho_init, s_init


def _relax(rho: Tensor, s: Tensor, fixed: Tensor, boundary: Tensor,
           iters: int):
    """Jacobi relaxation of rho and s_rho: free cells move toward the
    8-neighbour mean; fixed cells clamp rho; boundary cells clamp s_rho
    (Integrate1Step semantics with w=1, fix_fixed=true)."""
    kernel = torch.tensor([[1.0, 1.0, 1.0],
                           [1.0, 0.0, 1.0],
                           [1.0, 1.0, 1.0]], dtype=rho.dtype,
                          device=rho.device)[None, None]

    def conv(img):
        return F.conv2d(img[None, None], kernel, padding=1)[0, 0]

    ncnt = conv(torch.ones_like(rho))
    r, sr = rho, s
    for _ in range(iters):
        mean_r = conv(r) / ncnt
        mean_s = conv(sr) / ncnt
        r, sr = torch.where(fixed, r, mean_r), torch.where(boundary, sr,
                                                           mean_s)
    return r, sr


def fill_depth(klm: KeylineMap, *, width: int, height: int, block: int = 8,
               iters: int = 60, s_rho_max: float = 20.0,
               coarse_to_fine: bool = True,
               bound_mode: str = BOUND_NONE) -> DepthFill:
    """Build the dense inverse-depth grid from an edge map, on the edge
    map's device."""
    gw = (width + block - 1) // block
    gh = (height + block - 1) // block
    rho, s, fixed = _seed(klm, gh, gw, block, s_rho_max)
    nfix = torch.sum(fixed)
    mean_rho = torch.sum(torch.where(fixed, rho, 0.0)) / torch.clamp(
        nfix, min=1).to(rho.dtype)
    if coarse_to_fine:
        rho0, s0 = _coarse_to_fine_init(rho, s, fixed, mean_rho)
    else:
        rho0 = torch.where(fixed, rho, mean_rho)
        s0 = s
    boundary = _boundary_mask(gh, gw, bound_mode, rho.device)
    # non-fixed boundary cells never receive relaxed uncertainty: they
    # keep the unknown-depth sentinel (the reference's inboundary cells
    # are excluded from the s_rho update everywhere)
    s0 = torch.where(boundary & ~fixed, 1e3, s0)
    dense, s_dense = _relax(rho0, s0, fixed, boundary | fixed, iters)
    return DepthFill(rho=dense, s_rho=s_dense, fixed=fixed, block=block)


def _scalar(v, like: Tensor) -> Tensor:
    return torch.as_tensor(v, dtype=like.dtype).to(like.device)


def grid_points_3d(fill: DepthFill, zfm, cx, cy):
    """Unproject the grid cells to 3D (camera frame); returns [GH, GW, 3]
    (depth_filler.h:107-170 accessors)."""
    gh, gw = fill.rho.shape
    dev, dt = fill.rho.device, fill.rho.dtype
    ys = (torch.arange(gh, device=dev).to(dt) + 0.5) * fill.block
    xs = (torch.arange(gw, device=dev).to(dt) + 0.5) * fill.block
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    rho = torch.clamp(fill.rho, min=1e-4)
    z = 1.0 / rho
    zfm, cx, cy = (_scalar(v, fill.rho) for v in (zfm, cx, cy))
    X = (gx - cx) * z / zfm
    Y = (gy - cy) * z / zfm
    return torch.stack([X, Y, z], dim=-1)


def surface_normals(fill: DepthFill, zfm, cx, cy):
    """Per-cell surface normals from central differences of the 3D grid
    (depth_filler.cpp:360-391)."""
    P = grid_points_3d(fill, zfm, cx, cy)
    dx = torch.zeros_like(P)
    dy = torch.zeros_like(P)
    dx[:, 1:-1] = P[:, 2:] - P[:, :-2]
    dy[1:-1, :] = P[2:, :] - P[:-2, :]
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.where(norm > 1e-9, norm, 1.0)
