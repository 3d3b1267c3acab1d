"""Edge-landmark bundle adjustment with Schur-complement reduction
(PyTorch counterpart of rebvo_tpu/backend/ba.py, single process).

The reference has no BA (its pose graph is a measurement log). Here:

  * landmarks are the VO's edge keylines: scalar inverse depths anchored
    in a host keyframe, observed in other keyframes along their edge
    normal (1-D residuals, the measurement the front end already uses);
  * scalar landmarks make the Schur elimination exact: the reduced camera
    system is H_pp - S^T diag(1/h_l) S, with S the per-landmark
    accumulation of pose-Jacobian x depth-Jacobian products, one
    [6F, L] x [L, 6F] product;
  * the reduced solve (6F x 6F, F keyframes) is dense.

Each observation's 1x13 Jacobian (anchor pose, observing pose, depth) is
written out by hand, batched over observations; the JAX package takes it
by forward-mode autodiff. Block sums are `index_add_` (atomics on CUDA,
so the order of the sums differs from run to run). Products are float32
with TF32 off, as the reference's `Precision.HIGHEST`. The solve is a
fixed number of Gauss-Newton steps with Levenberg damping and an
accept/reject test per step, with no host read inside.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from rebvo_tpu_torch.core.geometry import so3_exp
from rebvo_tpu_torch.core.numerics import round_int

Tensor = torch.Tensor


class BAProblem(NamedTuple):
    """Fixed-size BA problem: L landmarks, O observations.

    Landmark l is anchored in keyframe `anchor[l]` at hom coords
    (lpx, lpy) with inverse depth rho[l]. Observation o sees landmark
    `obs_lm[o]` in keyframe `obs_kf[o]` at hom coords (mx, my), with edge
    normal (ux, uy) and weight w (1/sigma_pixels)."""

    anchor: Tensor   # [L] int32
    lpx: Tensor      # [L]
    lpy: Tensor      # [L]
    rho: Tensor      # [L] inverse depth state
    lvalid: Tensor   # [L] bool
    obs_lm: Tensor   # [O] int32
    obs_kf: Tensor   # [O] int32
    mx: Tensor       # [O]
    my: Tensor       # [O]
    ux: Tensor       # [O]
    uy: Tensor       # [O]
    w: Tensor        # [O]
    ovalid: Tensor   # [O] bool


def _mv(M: Tensor, v: Tensor) -> Tensor:
    """Batched 3x3 matrix times 3-vector: [N,3,3] x [N,3] -> [N,3]."""
    return (M * v[..., None, :]).sum(-1)


def _obs_residual(R: Tensor, p: Tensor, prob: BAProblem, zfm,
                  jac: bool = False):
    """1-D residual of every observation and, with `jac`, its Jacobian
    under local perturbations: poses are camera-to-world (Xw = R Xc + p),
    perturbed on the left (R <- exp(dw) R, p <- p + dp); depth additively.
    Returns r [O] or (r, Ja [O,6], Jf [O,6], Jr [O])."""
    lm = prob.obs_lm.long()
    a = prob.anchor[lm].long()
    f = prob.obs_kf.long()
    Ra, Rf = R[a], R[f]
    rho = prob.rho[lm]
    z = 1.0 / rho
    ray = torch.stack([prob.lpx[lm] / zfm, prob.lpy[lm] / zfm,
                       torch.ones_like(z)], -1)
    Xa = torch.stack([prob.lpx[lm] * z / zfm, prob.lpy[lm] * z / zfm, z], -1)
    A = _mv(Ra, Xa)
    D = A + p[a] - p[f]
    Xf = _mv(Rf.transpose(-1, -2), D)
    # sign-preserving depth clamp: a point that wanders behind the camera
    # during an iteration must not poison the solve with inf/NaN (the
    # robust weight then suppresses the huge residual)
    az = torch.abs(Xf[:, 2])
    z_safe = torch.sign(Xf[:, 2]) * torch.clamp(az, min=0.05)
    z_safe = torch.where(z_safe == 0, torch.full_like(z_safe, 0.05), z_safe)
    hx = Xf[:, 0] * zfm / z_safe
    hy = Xf[:, 1] * zfm / z_safe
    r = prob.ux * (hx - prob.mx) + prob.uy * (hy - prob.my)
    if not jac:
        return r
    # dr/dXf; the clamp passes the depth's derivative only above 0.05
    # (half of it at the tie, as jnp.maximum's derivative does)
    dzs = torch.where(az > 0.05, torch.ones_like(az),
                      torch.where(az == 0.05, torch.full_like(az, 0.5),
                                  torch.zeros_like(az)))
    g = torch.stack([prob.ux * zfm / z_safe, prob.uy * zfm / z_safe,
                     -(prob.ux * hx + prob.uy * hy) / z_safe * dzs], -1)
    q = _mv(Rf, g)                     # dr/dXw
    Ja = torch.cat([torch.linalg.cross(A, q, dim=-1), q], -1)
    Jf = torch.cat([torch.linalg.cross(q, D, dim=-1), -q], -1)
    Jr = (q * _mv(Ra, -ray * (z * z)[:, None])).sum(-1)
    return r, Ja, Jf, Jr


def _robust_weight(r: Tensor, prob: BAProblem, huber_k: float) -> Tensor:
    """Observation weight times the Huber IRLS weight of the weighted
    residual; 0 for unused observations."""
    use = prob.ovalid & prob.lvalid[prob.obs_lm.long()]
    wgt = torch.where(use, prob.w, torch.zeros_like(prob.w))
    rw = torch.abs(r * wgt)
    hub = torch.where(rw > huber_k,
                      torch.sqrt(huber_k / torch.clamp(rw, min=1e-12)),
                      torch.ones_like(rw))
    return wgt * hub


def _build_terms(R: Tensor, p: Tensor, prob: BAProblem, zfm,
                 huber_k: float):
    """Per-observation residual, Jacobians (13 local dofs) and robust
    weights: (r, Ja [O,6], Jf [O,6], Jr, wgt)."""
    r, Ja, Jf, Jr = _obs_residual(R, p, prob, zfm, jac=True)
    return r, Ja, Jf, Jr, _robust_weight(r, prob, huber_k)


def _eval_cost(R: Tensor, p: Tensor, prob: BAProblem, zfm,
               huber_k: float) -> Tensor:
    """Residual-only robust cost (no Jacobians) for the step control."""
    r = _obs_residual(R, p, prob, zfm)
    rw = r * _robust_weight(r, prob, huber_k)
    return torch.sum(rw * rw)


def _outer(u: Tensor, v: Tensor) -> Tensor:
    return u[:, :, None] * v[:, None, :]


def _reduce_terms(r, Ja, Jf, Jr, wgt, prob: BAProblem, F: int):
    """Assemble H_pp [6F,6F], b_p [6F] and the landmark-block quantities
    h_l [L], g_l [L], S [L,6F]; and the cost."""
    dt, dev = r.dtype, r.device
    L = prob.rho.shape[0]
    lm = prob.obs_lm.long()
    a = prob.anchor[lm].long()
    f = prob.obs_kf.long()

    Jas = Ja * wgt[:, None]
    Jfs = Jf * wgt[:, None]
    Jrs = Jr * wgt
    rs = r * wgt

    # dense pose Hessian: [F*F] 6x6 blocks, block (i, j) at i*F + j
    cross = _outer(Jas, Jfs)
    Hb = torch.zeros((F * F, 6, 6), dtype=dt, device=dev)
    Hb.index_add_(0, a * F + a, _outer(Jas, Jas))
    Hb.index_add_(0, f * F + f, _outer(Jfs, Jfs))
    Hb.index_add_(0, a * F + f, cross)
    Hb.index_add_(0, f * F + a, cross.transpose(1, 2))
    H = Hb.view(F, F, 6, 6).permute(0, 2, 1, 3).reshape(F * 6, F * 6)
    b = torch.zeros((F, 6), dtype=dt, device=dev)
    b.index_add_(0, a, Jas * rs[:, None])
    b.index_add_(0, f, Jfs * rs[:, None])

    h_l = torch.zeros((L,), dtype=dt, device=dev).index_add_(0, lm, Jrs * Jrs)
    g_l = torch.zeros((L,), dtype=dt, device=dev).index_add_(0, lm, Jrs * rs)
    S = torch.zeros((L * F, 6), dtype=dt, device=dev)
    S.index_add_(0, lm * F + a, Jas * Jrs[:, None])
    S.index_add_(0, lm * F + f, Jfs * Jrs[:, None])
    return H, b.reshape(F * 6), h_l, g_l, S.view(L, F * 6), torch.sum(rs * rs)


def _gauge_fix(H_red: Tensor, b_red: Tensor, F: int, damping):
    """Damp, and pin the first pose by excising its rows and columns (an
    identity block): a huge diagonal prior would wreck the float32
    conditioning."""
    eye = torch.eye(F * 6, dtype=H_red.dtype, device=H_red.device)
    H_red = H_red + eye * damping
    pinned = torch.zeros(F * 6, dtype=torch.bool, device=H_red.device)
    pinned[:6] = True
    rowcol = pinned[:, None] | pinned[None, :]
    H_red = torch.where(rowcol, eye, H_red)
    b_red = torch.where(pinned, torch.zeros_like(b_red), b_red)
    return H_red, b_red


def _schur_solve(H, b, h_l, g_l, S, F: int, damping):
    inv_h = torch.where(h_l > 1e-12, 1.0 / (h_l + damping),
                        torch.zeros_like(h_l))
    H_red = H - (S * inv_h[:, None]).T @ S
    b_red = b - S.T @ (inv_h * g_l)
    H_red, b_red = _gauge_fix(H_red, b_red, F, damping)
    dx = torch.linalg.solve_ex(H_red, -b_red)[0]
    drho = -inv_h * (g_l + S @ dx)
    return dx, drho


def _apply_update(R, p, rho, dx, drho, max_drho=0.5):
    dxp = dx.reshape(R.shape[0], 6)
    R2 = so3_exp(dxp[:, :3]) @ R
    p2 = p + dxp[:, 3:]
    rho2 = torch.clamp(rho + torch.clamp(drho, -max_drho, max_drho),
                       1e-4, 30.0)
    return R2, p2, rho2


def ba_solve(R: Tensor, p: Tensor, prob: BAProblem, zfm, iters: int = 8,
             huber_k: float = 3.0, damping: float = 1e-3
             ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Gauss-Newton BA on the problem's device. Returns (R', p', rho',
    costs [iters]), costs[i] the cost before step i; a step that does not
    lower the cost is rejected and the damping raised 8x (halved on
    accept, within [1e-6, 1e6])."""
    F = R.shape[0]
    rho = prob.rho
    lam = torch.full((), damping, dtype=p.dtype, device=p.device)
    costs = []
    for _ in range(iters):
        pb = prob._replace(rho=rho)
        r, Ja, Jf, Jr, wgt = _build_terms(R, p, pb, zfm, huber_k)
        H, b, h_l, g_l, S, cost = _reduce_terms(r, Ja, Jf, Jr, wgt, pb, F)
        dx, drho = _schur_solve(H, b, h_l, g_l, S, F, lam)
        R2, p2, rho2 = _apply_update(R, p, rho, dx, drho)
        cost_new = _eval_cost(R2, p2, pb._replace(rho=rho2), zfm, huber_k)
        acc = (cost_new < cost) & torch.isfinite(cost_new)
        R = torch.where(acc, R2, R)
        p = torch.where(acc, p2, p)
        rho = torch.where(acc, rho2, rho)
        lam = torch.clamp(torch.where(acc, lam * 0.5, lam * 8.0), 1e-6, 1e6)
        costs.append(cost)
    return R, p, rho, torch.stack(costs)


def partition_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Host-side re-layout for a landmark-sharded solve: landmarks into
    contiguous equal blocks and each valid observation onto its
    landmark's shard, `obs_lm` rewritten to shard-local ids; both axes
    padded to multiples of n_shards. A stable sort by shard plus a
    per-shard rank gives every observation's slot (numpy)."""
    dev = prob.rho.device
    host = BAProblem(*[x.detach().cpu().numpy() for x in prob])
    L = host.rho.shape[0]
    Lp = ((L + n_shards - 1) // n_shards) * n_shards
    per_l = Lp // n_shards

    def pad_l(a, fill=0):
        return np.concatenate([a, np.full((Lp - L,) + a.shape[1:], fill,
                                          a.dtype)])

    shard_of = host.obs_lm // per_l
    valid_idx = np.nonzero(host.ovalid)[0]
    vshard = shard_of[valid_idx]
    order = np.argsort(vshard, kind="stable")
    src = valid_idx[order]
    sshard = vshard[order]
    counts = np.bincount(sshard, minlength=n_shards)
    per_o = int(counts.max()) if counts.size and counts.max() > 0 else 1
    Op = per_o * n_shards
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(src.shape[0]) - starts[sshard]
    dst = sshard * per_o + rank

    def new_obs(a, fill=0):
        out = np.full((Op,) + a.shape[1:], fill, a.dtype)
        out[dst] = a[src]
        return out

    ovalid = np.zeros(Op, bool)
    ovalid[dst] = True
    out = BAProblem(
        anchor=pad_l(host.anchor), lpx=pad_l(host.lpx), lpy=pad_l(host.lpy),
        rho=pad_l(host.rho, 1.0), lvalid=pad_l(host.lvalid, False),
        obs_lm=new_obs(host.obs_lm, 0) % per_l, obs_kf=new_obs(host.obs_kf),
        mx=new_obs(host.mx), my=new_obs(host.my), ux=new_obs(host.ux),
        uy=new_obs(host.uy), w=new_obs(host.w), ovalid=ovalid)
    return BAProblem(*[torch.as_tensor(x).to(dev) for x in out])


def _slot(klm, g):
    return type(klm)(*[x[g] for x in klm])


def problem_from_keyframes(store, zfm: float, *, width: int, height: int,
                           cx: float, cy: float, match_thresh: float = 0.75,
                           max_s_rho: float = 20.0, field_radius: int = 4,
                           window: int = 2, rho_sigma: float = 3.0,
                           mutual_px: float = 0.0, revisit_dist: float = 0.0,
                           revisit_min_gap: int = 8,
                           landmark_stride: int = 1) -> BAProblem:
    """Build a BA problem from a KeyframeStore by re-matching each
    keyframe's keylines into the `window` following keyframes (the
    correspondences the reference's kfvo builds online,
    kfvo.cpp:739-1041, rebuilt offline from the stored maps).

    Landmarks: every valid keyline of keyframes 0..F-2 (F the store's
    capacity), anchored in its keyframe at its stored position and depth
    (global id f*K + k). Observations: the landmark transported into
    keyframes f+1..f+window by the stored poses and matched to the
    nearest keyline of the target map through a match field, behind three
    gates: gradient similarity (Test_f_k), inverse-depth consistency
    within `rho_sigma` sigma (Calc_f_J_Complete), and, with
    `mutual_px > 0`, the round trip of the matched keyline back into the
    source keyframe (mutualExclusionSimple's offline analogue).
    `window >= 2` lets one landmark's depth tie the scales of consecutive
    pairs.

    `revisit_dist > 0` also pairs non-consecutive keyframes whose stored
    positions lie within that distance and at least `revisit_min_gap`
    apart; like the JAX package's loop, it never pairs keyframe F-1 as a
    revisit target. `landmark_stride` keeps every Nth keyline."""
    from rebvo_tpu_torch.backend.kfvo import relative_pose, transform_map
    from rebvo_tpu_torch.kernels.field import build_field

    F = store.capacity
    K = store.klm.x.shape[1]
    dt, dev = store.Pos.dtype, store.Pos.device
    fields = [build_field(_slot(store.klm, g),
                          torch.zeros((), dtype=dt, device=dev),
                          radius=field_radius, height=height,
                          width=width).reshape(-1)
              for g in range(F)]
    lm_keep = torch.arange(K, device=dev) % max(landmark_stride, 1) == 0
    kidx = torch.arange(K, dtype=torch.int32, device=dev)

    def pair(f, g):
        src, dst = _slot(store.klm, f), _slot(store.klm, g)
        ok_pair = store.valid[f] & store.valid[g]
        R, t = relative_pose(store.Pose[f], store.Pos[f], store.Pose[g],
                             store.Pos[g])
        moved = transform_map(src, R, t, zfm)

        xr = round_int(moved.px + cx)
        yr = round_int(moved.py + cy)
        inb = (xr >= 1) & (yr >= 1) & (xr < width - 1) & (yr < height - 1)
        lin = (torch.clamp(yr, 0, height - 1) * width
               + torch.clamp(xr, 0, width - 1)).long()
        j = torch.where(inb, fields[g][lin], torch.full_like(xr, -1))
        js = torch.clamp(j, min=0).long()

        # gradient-similarity gate (Test_f_k)
        p_n2 = moved.n_m * moved.n_m
        p_esc = moved.gx * dst.gx[js] + moved.gy * dst.gy[js]
        grad_ok = torch.abs(p_esc - p_n2) <= match_thresh * p_n2
        # inverse-depth consistency gate (Calc_f_J_Complete,
        # global_tracker.cpp:115-169)
        s_d = dst.s_rho[js]
        sig = torch.sqrt(moved.s_rho ** 2 + s_d ** 2)
        rho_ok = torch.abs(moved.rho - dst.rho[js]) <= rho_sigma * sig
        if mutual_px > 0:
            # the matched keyline back into the source keyframe at its own
            # depth must land on the source keyline: an occlusion match
            # carries the occluder's depth and lands off by its parallax
            Rb = R.T
            tb = -(R.T @ t)
            Pz = 1.0 / torch.clamp(dst.rho[js], min=1e-6)
            Px = dst.px[js] * Pz / zfm
            Py = dst.py[js] * Pz / zfm
            bx3 = Rb[0, 0] * Px + Rb[0, 1] * Py + Rb[0, 2] * Pz + tb[0]
            by3 = Rb[1, 0] * Px + Rb[1, 1] * Py + Rb[1, 2] * Pz + tb[1]
            bz3 = Rb[2, 0] * Px + Rb[2, 1] * Py + Rb[2, 2] * Pz + tb[2]
            bz3 = torch.where(torch.abs(bz3) > 1e-9, bz3,
                              torch.full_like(bz3, 1e-9))
            bx = bx3 * zfm / bz3
            by = by3 * zfm / bz3
            tol = mutual_px + zfm * torch.linalg.norm(t) * s_d
            mutual_ok = ((bx - src.px) ** 2 + (by - src.py) ** 2
                         <= tol * tol)
        else:
            mutual_ok = torch.ones_like(rho_ok)

        good = (src.valid & dst.valid[js] & (j >= 0) & grad_ok & rho_ok
                & mutual_ok & ok_pair & (src.s_rho <= max_s_rho) & lm_keep)
        w = torch.where(good, 1.0 / torch.clamp(s_d, min=0.05),
                        torch.zeros_like(s_d))
        return dict(obs_lm=kidx + f * K,
                    obs_kf=torch.full((K,), g, dtype=torch.int32,
                                      device=dev),
                    mx=dst.x[js] - cx, my=dst.y[js] - cy,
                    ux=dst.ux[js], uy=dst.uy[js], w=w, ovalid=good)

    def landmarks(f):
        src = _slot(store.klm, f)
        return dict(anchor=torch.full((K,), f, dtype=torch.int32,
                                      device=dev),
                    lpx=src.px, lpy=src.py, rho=src.rho,
                    lvalid=src.valid & store.valid[f] & lm_keep)

    lms = [landmarks(f) for f in range(F - 1)]
    pairs = [(f, g) for f in range(F - 1)
             for g in range(f + 1, min(f + window, F - 1) + 1)]
    if revisit_dist > 0:
        P = store.Pos.detach().cpu().numpy()
        live = store.valid.detach().cpu().numpy()
        have = set(pairs)
        for f in range(F - 1):
            if not live[f]:
                continue
            d = np.linalg.norm(P - P[f], axis=1)
            for g in range(f + revisit_min_gap, F - 1):
                if live[g] and d[g] < revisit_dist and (f, g) not in have:
                    pairs.append((f, g))
                    have.add((f, g))
    obs = [pair(f, g) for f, g in pairs]
    return BAProblem(
        **{k: torch.cat([m[k] for m in lms])
           for k in ("anchor", "lpx", "lpy", "rho", "lvalid")},
        **{k: torch.cat([o[k] for o in obs])
           for k in ("obs_lm", "obs_kf", "mx", "my", "ux", "uy", "w",
                     "ovalid")})


def synth_ring_problem(F: int, L: int, obs_per: int, zfm: float,
                       seed: int = 0, rho_noise: float = 0.1,
                       device="cuda"):
    """Deterministic synthetic BA problem (the JAX package's, from the
    same seed): F cameras on a ring, L landmarks anchored uniformly, each
    observed from the `obs_per` following keyframes with exact
    reprojections, log-normal noise on the inverse depths.

    Returns (R_true [F,3,3], p_true [F,3], rho_true [L] as numpy,
    BAProblem on `device`)."""
    rng = np.random.RandomState(seed)
    ang = np.linspace(0, 2 * np.pi, F, endpoint=False)
    p_true = np.stack([np.cos(ang), np.sin(ang), np.zeros(F)],
                      1).astype(np.float32) * 0.5
    R_true = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
    anchor = rng.randint(0, F, L).astype(np.int32)
    lpx = rng.uniform(-60, 60, L).astype(np.float32)
    lpy = rng.uniform(-40, 40, L).astype(np.float32)
    rho_true = rng.uniform(0.2, 1.0, L).astype(np.float32)

    l_idx = np.repeat(np.arange(L), obs_per)
    off = np.tile(np.arange(1, obs_per + 1), L)
    f_idx = (anchor[l_idx] + off) % F
    z = 1.0 / rho_true[l_idx]
    Xa = np.stack([lpx[l_idx] * z / zfm, lpy[l_idx] * z / zfm, z], 1)
    Xw = np.einsum("fij,fj->fi", R_true[anchor[l_idx]], Xa) + \
        p_true[anchor[l_idx]]
    Xf = np.einsum("fji,fj->fi", R_true[f_idx], Xw - p_true[f_idx])
    mx = (Xf[:, 0] * zfm / Xf[:, 2]).astype(np.float32)
    my = (Xf[:, 1] * zfm / Xf[:, 2]).astype(np.float32)
    th = rng.uniform(0, np.pi, l_idx.shape[0])
    O = l_idx.shape[0]
    rho0 = rho_true * np.exp(rng.randn(L).astype(np.float32) * rho_noise)
    prob = BAProblem(
        anchor=anchor, lpx=lpx, lpy=lpy, rho=rho0,
        lvalid=np.ones((L,), bool), obs_lm=l_idx.astype(np.int32),
        obs_kf=f_idx.astype(np.int32), mx=mx, my=my,
        ux=np.cos(th).astype(np.float32), uy=np.sin(th).astype(np.float32),
        w=np.ones((O,), np.float32), ovalid=np.ones((O,), bool))
    return R_true, p_true, rho_true, BAProblem(
        *[torch.as_tensor(x).to(device) for x in prob])
