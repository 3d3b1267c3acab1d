"""Edge detection: DoG zero-crossing keylines with subpixel refinement
(PyTorch counterpart of rebvo_tpu/kernels/edge_detect.py; reference
edge_finder, src/mtracklib/edge_finder.cpp:67-405).

* the per-pixel candidate tests are separable window sums (the plane
  fit's pseudo-inverse collapses to three weighted window sums);
* compaction into the fixed KeylineMap is a cumsum compaction into K
  slots in raster order (the reference's scan order and kl_max
  truncation) — no `nonzero`, so no host sync;
* chain linking is a 3-way masked gather on the id mask plus a
  scatter-max for the back links.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from vobench.reference.core.numerics import div_const, to_int32
from vobench.reference.frontend.state import RHO_INIT, RHO_MAX, KeylineMap
from vobench.reference.kernels.scale_space import ScaleSpace

Tensor = torch.Tensor


def _shift2d(img: Tensor, di: int, dj: int) -> Tensor:
    """Zero-padded shift: out[y, x] = img[y + di, x + dj]."""
    H, W = img.shape[-2], img.shape[-1]
    p = F.pad(img, (max(-dj, 0), max(dj, 0), max(-di, 0), max(di, 0)))
    y0 = max(di, 0)
    x0 = max(dj, 0)
    return p[..., y0:y0 + H, x0:x0 + W]


def _window_sum(img: Tensor, w: int) -> Tensor:
    """Unnormalised (2w+1)^2 window sum via separable shifts."""
    row = sum(_shift2d(img, 0, j) for j in range(-w, w + 1))
    return sum(_shift2d(row, i, 0) for i in range(-w, w + 1))


def _window_wsum_x(img: Tensor, w: int) -> Tensor:
    """Window sum weighted by the x-offset j (plane-fit slope)."""
    row = sum(float(j) * _shift2d(img, 0, j)
              for j in range(-w, w + 1) if j != 0)
    return sum(_shift2d(row, i, 0) for i in range(-w, w + 1))


def _window_wsum_y(img: Tensor, w: int) -> Tensor:
    col = sum(float(i) * _shift2d(img, i, 0)
              for i in range(-w, w + 1) if i != 0)
    return sum(_shift2d(col, 0, j) for j in range(-w, w + 1))


class EdgeCandidates(NamedTuple):
    mask: Tensor     # [H, W] bool — pixel passes every detector test
    theta_x: Tensor  # DoG plane gradient (keyline gradient m_m)
    theta_y: Tensor
    xs: Tensor       # subpixel offsets of the zero crossing
    ys: Tensor
    n2_m: Tensor     # squared DoG-gradient norm


def detect_candidates(ss: ScaleSpace, win_s: int, per_hist: float,
                      grad_thresh: Tensor, dog_thresh: float,
                      max_img_value: float) -> EdgeCandidates:
    """Per-pixel detector tests (edge_finder::build_mask,
    edge_finder.cpp:67-214)."""
    H, W = ss.dog.shape[-2:]
    win_area = float((2 * win_s + 1) ** 2)
    sum_j2 = float((2 * win_s + 1) *
                   sum(j * j for j in range(-win_s, win_s + 1)))
    grad_thresh = torch.as_tensor(grad_thresh, dtype=ss.dog.dtype,
                                  device=ss.dog.device)
    g = grad_thresh * max_img_value

    n2gI = ss.dx * ss.dx + ss.dy * ss.dy
    t1 = n2gI >= g * g

    sign = torch.where(ss.dog > 0, 1.0, -1.0).to(ss.dog.dtype)
    pn = _window_sum(sign, win_s)
    t2 = torch.abs(pn) <= win_area * per_hist

    theta_x = div_const(_window_wsum_x(ss.dog, win_s), sum_j2)
    theta_y = div_const(_window_wsum_y(ss.dog, win_s), sum_j2)
    theta_c = div_const(_window_sum(ss.dog, win_s), win_area)

    n2_m = theta_x * theta_x + theta_y * theta_y
    denom = torch.where(n2_m > 0, n2_m, torch.ones_like(n2_m))
    xs = -theta_x * theta_c / denom
    ys = -theta_y * theta_c / denom

    t3 = (torch.abs(xs) <= 0.5) & (torch.abs(ys) <= 0.5)
    gd = g * dog_thresh
    t4 = n2_m >= gd * gd

    yy = torch.arange(H, device=ss.dog.device)[:, None]
    xx = torch.arange(W, device=ss.dog.device)[None, :]
    interior = (yy >= win_s) & (yy < H - win_s) & \
        (xx >= win_s) & (xx < W - win_s)

    mask = t1 & t2 & t3 & t4 & interior
    return EdgeCandidates(mask=mask, theta_x=theta_x, theta_y=theta_y,
                          xs=xs, ys=ys, n2_m=n2_m)


def _neighbor_offsets(tx: Tensor, ty: Tensor):
    """NextPoint's quadrant-ordered 3-neighbour priority list
    (edge_finder.cpp:221-297)."""
    one = torch.ones_like(tx, dtype=torch.int32)
    up = ty > 0
    dx_lat = torch.where(up, torch.where(tx > 0, one, -one),
                         torch.where(tx >= 0, one, -one))
    dy_fwd = torch.where(up, one, -one)
    z = torch.zeros_like(dx_lat)
    return ((dx_lat, z), (z, dy_fwd), (dx_lat, dy_fwd))


def detect_keylines(ss: ScaleSpace, grad_thresh: Tensor, *, K: int,
                    kl_max: int, win_s: int, per_hist: float,
                    dog_thresh: float, max_img_value: float, cx: float,
                    cy: float) -> Tuple[KeylineMap, Tensor, Tensor]:
    """Detect, compact and link keylines (edge_finder::detect).
    Returns (keyline map, id-mask image [H,W] int32, keyline count)."""
    cand = detect_candidates(ss, win_s, per_hist, grad_thresh, dog_thresh,
                             max_img_value)
    return compact_keylines(cand, K=K, kl_max=kl_max, cx=cx, cy=cy)


def compact_keylines(cand: EdgeCandidates, *, K: int, kl_max: int,
                     cx: float, cy: float
                     ) -> Tuple[KeylineMap, Tensor, Tensor]:
    """Compact + chain-link detector candidates into the fixed keyline SoA
    (the back half of edge_finder::detect). Slot s holds the s-th set
    pixel in raster order; unused slots point at pixel 0, like the
    reference's sized nonzero with fill 0."""
    H, W = cand.mask.shape[-2:]
    dev = cand.mask.device
    flat = cand.mask.reshape(-1)
    n_pix = H * W
    pix_all = torch.arange(n_pix, device=dev, dtype=torch.int64)
    pos = torch.cumsum(flat.to(torch.int32), dim=0) - 1
    take = flat & (pos < K)
    dest = torch.where(take, pos.to(torch.int64), torch.full_like(pix_all, K))
    # out of place throughout (scatter, scatter_reduce, scatter_add):
    # under vmap the source is batched and the fresh buffer is not
    pix_idx = torch.zeros(K + 1, dtype=torch.int64, device=dev).scatter(
        0, dest, pix_all)[:K]                # slot K is the dump slot

    total = torch.sum(flat, dtype=torch.int32)
    n_keep = torch.clamp(total, max=min(kl_max, K))
    slot = torch.arange(K, dtype=torch.int32, device=dev)
    valid = slot < n_keep

    piy = torch.div(pix_idx, W, rounding_mode="floor").to(torch.int32)
    pix = (pix_idx % W).to(torch.int32)

    def gather(img):
        return img.reshape(-1)[pix_idx]

    gx = gather(cand.theta_x)
    gy = gather(cand.theta_y)
    n2 = gather(cand.n2_m)
    n_m = torch.sqrt(torch.where(n2 > 0, n2, torch.ones_like(n2)))
    ux = gx / n_m
    uy = gy / n_m
    x = pix.to(gx.dtype) + gather(cand.xs)
    y = piy.to(gx.dtype) + gather(cand.ys)
    px = x - cx
    py = y - cy

    # id-mask image: keyline slot at its integer pixel, -1 elsewhere; the
    # extra element n_pix is the dump slot of the reference's mode="drop"
    drop = torch.where(valid, pix_idx, torch.full_like(pix_idx, n_pix))
    mask_img = torch.full((n_pix + 1,), -1, dtype=torch.int32,
                          device=dev).scatter(0, drop, slot)
    mask_img = mask_img[:n_pix].reshape(H, W)

    # join_edges: next-id via quadrant gather, prev-id via scatter-max
    rx = torch.clamp(to_int32(torch.round(x)), 0, W - 1)
    ry = torch.clamp(to_int32(torch.round(y)), 0, H - 1)
    tx = -gy
    ty = gx
    neg = torch.full((K,), -1, dtype=torch.int32, device=dev)
    n_id = neg
    found = torch.zeros((K,), dtype=torch.bool, device=dev)
    for dxo, dyo in _neighbor_offsets(tx, ty):
        nx = rx + dxo
        ny = ry + dyo
        inb = (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
        hit = mask_img[torch.clamp(ny, 0, H - 1), torch.clamp(nx, 0, W - 1)]
        cand_id = torch.where(inb, hit, neg)
        n_id = torch.where((~found) & (cand_id >= 0), cand_id, n_id)
        found = found | (cand_id >= 0)
    n_id = torch.where(valid, n_id, neg)

    tgt = torch.where((n_id >= 0) & valid, n_id,
                      torch.full_like(n_id, K)).to(torch.int64)
    p_id = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
    p_id = p_id.scatter_reduce(0, tgt, slot, reduce="amax",
                               include_self=True)[:K]

    dt = gx.dtype
    f0 = torch.zeros((K,), dtype=dt, device=dev)
    zero = f0
    one = torch.ones_like(f0)

    def v(a, fill):
        return torch.where(valid, a, fill)

    klm = KeylineMap(
        valid=valid,
        x=v(x, zero), y=v(y, zero), gx=v(gx, zero), gy=v(gy, zero),
        n_m=v(n_m, one), ux=v(ux, zero), uy=v(uy, zero),
        px=v(px, zero), py=v(py, zero), p0x=v(px, zero), p0y=v(py, zero),
        g0x=v(gx, zero), g0y=v(gy, zero), n_m0=v(n_m, one),
        rho=f0 + RHO_INIT, s_rho=f0 + RHO_MAX,
        rho0=f0 + RHO_INIT, s_rho0=f0 + RHO_MAX,
        m_num=torch.zeros((K,), dtype=torch.int32, device=dev),
        m_id=neg.clone(), m_id_f=neg.clone(), m_id_kf=neg.clone(),
        p_id=p_id, n_id=n_id,
        anchored=torch.zeros((K,), dtype=torch.bool, device=dev),
        rho_st=f0, ax=f0, ay=f0, arho=f0,
    )
    return klm, mask_img, n_keep


def update_detector_threshold(thresh: Tensor, last_kl_num: Tensor,
                              kl_ref: int, gain: float, thresh_max: float,
                              thresh_min: float) -> Tensor:
    """Proportional auto-threshold (UpdateThresh, edge_finder.cpp:330-335)."""
    if gain <= 0:
        return thresh
    t = thresh - gain * (kl_ref - last_kl_num.to(thresh.dtype))
    return torch.clamp(t, thresh_min, thresh_max)


def re_estimate_thresh(klm: KeylineMap, knum: int, nbins: int) -> Tensor:
    """Histogram threshold keeping roughly the top-`knum` keylines by DoG
    gradient norm (edge_finder::reEstimateThresh, edge_finder.cpp:373-405),
    reproducing the reference's walk that skips bin 0."""
    n_m = klm.n_m
    valid = klm.valid
    max_dog = torch.max(torch.where(valid, n_m, torch.full_like(n_m,
                                                                -float("inf"))))
    min_dog = torch.min(torch.where(valid, n_m, torch.full_like(n_m,
                                                                float("inf"))))
    any_valid = torch.any(valid)
    max_dog = torch.where(any_valid, max_dog, torch.ones_like(max_dog))
    min_dog = torch.where(any_valid, min_dog, torch.zeros_like(min_dog))
    span = torch.where(max_dog > min_dog, max_dog - min_dog,
                       torch.ones_like(max_dog))

    i = torch.clamp(to_int32(nbins * (max_dog - n_m) / span), 0, nbins - 1)
    i_eff = torch.where(valid, i, torch.full_like(i, nbins)).to(torch.int64)
    hist = torch.zeros(nbins + 1, dtype=torch.int32, device=n_m.device)
    hist = hist.scatter_add(0, i_eff, torch.ones_like(i))[:nbins]
    csum = torch.cumsum(hist, dim=0) - hist[0]      # sum of bins 1..i
    reached = csum >= knum
    first = torch.argmax(reached.to(torch.int32))
    i_star = torch.where(torch.any(reached), first,
                         torch.full_like(first, nbins))
    return max_dog - i_star.to(n_m.dtype) * span / nbins
