"""Line fitting: 2-D total-least-squares and 3-D edge-segment fits.

Re-implements the behaviour of LineFitting (reference
src/UtilLib/linefitting.cpp): the 2-D TLS direction via the scatter
matrix eigen-direction, and the sigma-weighted 3-D segment fit in
(image x, image y, inverse depth) space used by the compressed edge-map
channel, with its robust re-fit variant. Vectorised over batches of
segments (leading axes broadcast).

The port's own copy of rebvo_tpu/core/linefitting.py (numpy only): the
compressed edge-map channel fits its segments on the host."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


def fit_line_2d(x: np.ndarray, y: np.ndarray, w: np.ndarray = None):
    """Weighted TLS line fit. Returns (cx, cy, dir_x, dir_y).

    Direction from the scatter-matrix angle atan2(2 Sxy, Sxx - Syy)/2
    (linefitting.cpp:24-43)."""
    if w is None:
        w = np.ones_like(x)
    ws = w.sum(axis=-1, keepdims=True)
    cx = (x * w).sum(axis=-1, keepdims=True) / ws
    cy = (y * w).sum(axis=-1, keepdims=True) / ws
    dx = x - cx
    dy = y - cy
    sxx = (w * dx * dx).sum(axis=-1)
    syy = (w * dy * dy).sum(axis=-1)
    sxy = (w * dx * dy).sum(axis=-1)
    ang = 0.5 * np.arctan2(2 * sxy, sxx - syy)
    return (cx[..., 0], cy[..., 0], np.cos(ang), np.sin(ang))


class Segment3D(NamedTuple):
    p0: np.ndarray   # [..., 3] endpoint (x, y, rho)
    p1: np.ndarray
    rms: np.ndarray  # [...] residual RMS in the weighted metric


def fit_segment_3d(x, y, rho, s_rho, mask=None) -> Segment3D:
    """Sigma-weighted 3-D line fit in (x, y, rho) space with endpoints at
    the projections of the first/last points (Fit3DLine,
    linefitting.cpp:56-105). rho entries are weighted by 1/s_rho^2; the
    spatial coordinates uniformly."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    rho = np.asarray(rho, np.float64)
    s_rho = np.asarray(s_rho, np.float64)
    if mask is None:
        mask = np.ones_like(x, bool)
    m = mask.astype(np.float64)
    wr = m / np.maximum(s_rho, 1e-6) ** 2

    n = np.maximum(m.sum(axis=-1), 1.0)
    mx = (x * m).sum(axis=-1) / n
    my = (y * m).sum(axis=-1) / n
    wn = np.maximum(wr.sum(axis=-1), 1e-12)
    mr = (rho * wr).sum(axis=-1) / wn

    # principal direction of the (x, y) spread; rho fitted linearly along it
    cx, cy, dx, dy = fit_line_2d(x, y, m)
    s = (x - mx[..., None]) * dx[..., None] + \
        (y - my[..., None]) * dy[..., None]
    # weighted slope of rho vs s
    num = (wr * s * (rho - mr[..., None])).sum(axis=-1)
    den = np.maximum((wr * s * s).sum(axis=-1), 1e-12)
    k = num / den

    def at(si):
        return np.stack([mx + dx * si, my + dy * si,
                         mr + k * si], axis=-1)

    # endpoints at the extreme projections of the masked points
    s_masked = np.where(mask, s, np.nan)
    s0 = np.nanmin(s_masked, axis=-1)
    s1 = np.nanmax(s_masked, axis=-1)
    p0 = at(s0)
    p1 = at(s1)

    rho_fit = mr[..., None] + k[..., None] * s
    perp = ((x - mx[..., None]) * (-dy[..., None]) +
            (y - my[..., None]) * dx[..., None])
    res2 = perp ** 2 + (rho - rho_fit) ** 2 * \
        (wr / np.maximum(wn[..., None] / n[..., None], 1e-12))
    rms = np.sqrt((res2 * m).sum(axis=-1) / n)
    return Segment3D(p0=p0, p1=p1, rms=rms)


def robust_fit_segment_3d(x, y, rho, s_rho, sigma_thresh=1.0,
                          mask=None) -> Tuple[Segment3D, np.ndarray]:
    """Fit, drop points beyond sigma_thresh * rms, re-fit
    (RobustFit3DLine semantics). Returns (segment, inlier mask)."""
    if mask is None:
        mask = np.ones_like(np.asarray(x), bool)
    seg = fit_segment_3d(x, y, rho, s_rho, mask)
    # residual recomputation for gating
    cx, cy, dx, dy = fit_line_2d(np.asarray(x, np.float64),
                                 np.asarray(y, np.float64),
                                 mask.astype(np.float64))
    perp = np.abs((np.asarray(x) - cx[..., None]) * (-dy[..., None]) +
                  (np.asarray(y) - cy[..., None]) * dx[..., None])
    keep = mask & (perp <= np.maximum(sigma_thresh * seg.rms[..., None],
                                      1e-9))
    # guard: keep at least 2 points
    enough = keep.sum(axis=-1) >= 2
    keep = np.where(enough[..., None], keep, mask)
    return fit_segment_3d(x, y, rho, s_rho, keep), keep
