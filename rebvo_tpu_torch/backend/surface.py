"""Occupancy-grid surface integration over keyframes (PyTorch
counterpart of rebvo_tpu/backend/surface.py).

Re-implements the behaviour of surface_integrator (reference
src/visualizer/surface_integrator.cpp): a world-space occupancy grid
accumulating every keyframe's dense-depth surfels (OcGrid), plus
visibility ray-culling between keyframes. Surfels from all keyframes
scatter-add into one voxel grid in a single op (an int32 `index_add_`
into one slot more than the grid, the last slot dropped); ray-culling
uses a batched sampling of each ray instead of the per-surfel recursive
cut. Plain PyTorch: the reference has no Pallas kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rebvo_tpu_torch.core.numerics import div_const, floor_int

Tensor = torch.Tensor


class OcGrid(NamedTuple):
    count: Tensor   # [Nx, Ny, Nz] int32 surfel hit counts
    lo: Tensor      # [3] world-space origin
    voxel: Tensor   # scalar voxel edge length


def world_bounds(points: Tensor, margin: float = 0.5):
    """Bounds estimate over surfel clouds (surface_integrator.cpp:32)."""
    P = points.reshape(-1, 3)
    return (torch.amin(P, dim=0) - margin, torch.amax(P, dim=0) + margin)


def _voxel_index(P: Tensor, lo: Tensor, voxel: Tensor, dims):
    """(flat index, in-bounds mask) of points [..., 3] in the grid."""
    ijk = floor_int((P - lo) / voxel)
    hi = torch.as_tensor(dims, dtype=torch.int32).to(P.device)
    inb = torch.all((ijk >= 0) & (ijk < hi), dim=-1)
    lin = (ijk[..., 0] * dims[1] + ijk[..., 1]) * dims[2] + ijk[..., 2]
    return lin, inb


def build_ocgrid(points: Tensor, valid: Tensor, lo: Tensor, voxel,
                 *, nx: int, ny: int, nz: int) -> OcGrid:
    """Scatter world points into the voxel grid (OcGrid fill,
    surface_integrator.cpp:120-233). points [..., 3], valid [...]."""
    P = points.reshape(-1, 3)
    voxel = torch.as_tensor(voxel, dtype=P.dtype).to(P.device)
    lin, inb = _voxel_index(P, lo, voxel, (nx, ny, nz))
    inb = inb & valid.reshape(-1)
    n = nx * ny * nz
    lin = torch.where(inb, lin, n).to(torch.int64)
    count = torch.zeros(n + 1, dtype=torch.int32, device=P.device)
    count.index_add_(0, lin, torch.ones_like(lin, dtype=torch.int32))
    return OcGrid(count=count[:n].reshape(nx, ny, nz), lo=lo, voxel=voxel)


def ray_cut_visibility(grid: OcGrid, cam_pos: Tensor, points: Tensor,
                       n_samples: int = 32, occupancy_min: int = 1
                       ) -> Tensor:
    """For each point, check whether the ray from the camera reaches it
    without crossing occupied voxels (the reference's ray-cut culling,
    surface_integrator.cpp:235-268). Returns a visibility mask."""
    nx, ny, nz = grid.count.shape
    P = points.reshape(-1, 3)
    ts = div_const(torch.arange(1, n_samples, device=P.device).to(P.dtype),
                   n_samples)[None, :, None]
    samples = cam_pos[None, None, :] + (P - cam_pos)[:, None, :] * ts
    lin, inb = _voxel_index(samples, grid.lo, grid.voxel, (nx, ny, nz))
    flat = grid.count.reshape(-1)
    occ = torch.where(inb, flat[torch.clamp(lin, 0, flat.numel() - 1)], 0)
    # exclude the last few samples (the target's own voxel neighbourhood)
    guard = int(n_samples * 0.9)
    blocked = torch.any(occ[:, :guard] >= occupancy_min, dim=-1)
    return (~blocked).reshape(points.shape[:-1])
