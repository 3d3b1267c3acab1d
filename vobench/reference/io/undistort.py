"""Precomputed undistortion map (PyTorch counterpart of
rebvo_tpu/io/undistort.py).

Replaces image_undistort (reference src/VideoLib/image_undistort.cpp:
29-123): for every output pixel, its ideal coordinates are distorted
through the camera model once at build time; applying the map is a
bilinear 4-tap gather of plain tensor ops on the frame's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.core.geometry import CameraModel
from vobench.reference.core.numerics import floor_int

Tensor = torch.Tensor


class UndistortMap(NamedTuple):
    src_x: Tensor   # [H, W] float32 source x for each output pixel
    src_y: Tensor


def build_undistort_map(cam: CameraModel, device="cuda") -> UndistortMap:
    """Distort each output pixel's ideal coordinate to find its source
    position in the distorted input (image_undistort.cpp:29-60). Computed
    in float32 on the CPU, as the JAX package computes it (its float64
    grids become float32 arrays; on CUDA PyTorch would turn the
    divisions by the focal length into multiplies), then moved to
    `device`."""
    H, W = cam.height, cam.width
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    dx, dy = cam.distort_hom(xs - cam.cx, ys - cam.cy)
    return UndistortMap(src_x=(dx + cam.cx).to(device),
                        src_y=(dy + cam.cy).to(device))


def apply_undistort(umap: UndistortMap, img: Tensor) -> Tensor:
    """Bilinear resample of the distorted input [..., H, W] onto the
    ideal grid (image_undistort.h:104-123); out-of-range sources clamp to
    the border."""
    H, W = img.shape[-2:]
    x = torch.clamp(umap.src_x, 0.0, W - 1)
    y = torch.clamp(umap.src_y, 0.0, H - 1)
    x0 = torch.clamp(floor_int(x), 0, W - 2)
    y0 = torch.clamp(floor_int(y), 0, H - 2)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(img.shape[:-2] + (-1,))
    idx = (y0 * W + x0).to(torch.int64)

    def g(off):
        return flat[..., idx + off]

    v00 = g(0)
    v01 = g(1)
    v10 = g(W)
    v11 = g(W + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)
