"""Frame-to-frame pose estimation by direct edge alignment (PyTorch
counterpart of rebvo_tpu/kernels/pose_solver.py; reference
global_tracker TryVelRot / Minimizer_RV / Minimizer_V,
src/mtracklib/global_tracker.cpp:285-1093).

The robust cost, the analytic Jacobian and the Levenberg-Marquardt
driver are the JAX package's (see its module docstring for the cost's
deviation from the reference). Here:
  * every function also takes a leading batch of states X [..., 6], which
    replaces the reference's `vmap` over warm-start candidates;
  * the LM loops have fixed iteration counts and select with `where`, and
    the linear solves are `solve_ex` / `inv_ex` (no error check, so no
    host sync; a singular system still gives non-finite values, which the
    step's nan_fail test relies on);
  * the LM's sums (J^T J, J^T F, the score, the predicted gain) are
    accumulated in float64 and rounded once to float32, its 6x6 solves
    and the in-plane rotation's sin and cos run in float64: its accept
    tests and rung choice compare these numbers, and a float32 sum in
    another order (the card's against the CPU's) flips them on a few
    frames of a long run, which the stereo scale carry then amplifies
    (core/numerics' module note).

`minimizer_rv` on a CUDA tensor is one launch of K3, the hand-written
kernel `csrc/pose_lm.cu` (built by `nvcc` at first use), through the
custom op `rebvo_tpu_torch::pose_lm`, whose vmap rule hands every vmapped
lane to that one launch. On a CPU tensor the op runs the plain version,
`minimizer_rv_plain` (lane by lane under vmap). There is no fallback from
the card to the plain version. `minimizer_v` stays plain ops.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.core.geometry import so3_exp
from rebvo_tpu_torch.core.numerics import matmul, round_int, sum64
from rebvo_tpu_torch.frontend.state import KeylineMap
from rebvo_tpu_torch.kernels import cuda_build

Tensor = torch.Tensor


class FieldView(NamedTuple):
    """What TryVelRot needs about the *new* edge map: the field image and
    the per-keyline attributes packed as [K, 8] rows."""

    ikl: Tensor     # [H, W] int32 field image (build_field output)
    attrs: Tensor   # [K, 8]: x, y, ux, uy, gx, gy, n_m, pad

    @staticmethod
    def from_map(field_img: Tensor, klm: KeylineMap) -> "FieldView":
        attrs = torch.stack(
            [klm.x, klm.y, klm.ux, klm.uy, klm.gx, klm.gy, klm.n_m,
             torch.zeros_like(klm.x)], dim=-1)
        return FieldView(ikl=field_img, attrs=attrs)


class TryVelRotResult(NamedTuple):
    score: Tensor     # [...] total robust cost
    JtJ: Tensor       # [..., 6, 6]
    JtF: Tensor       # [..., 6]
    residual: Tensor  # [..., K]
    m_id_f: Tensor    # [..., K] forward match ids (-1 = none)
    q_rho: Tensor     # [..., K] noise shaping at this state


def _solve64(A: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.solve_ex(A.double(), b.double())[0].to(A.dtype)


def _inv64(A: Tensor) -> Tensor:
    return torch.linalg.inv_ex(A.double())[0].to(A.dtype)


def try_vel_rot(X: Tensor, old: KeylineMap, fv: FieldView,
                q_frozen: Tensor = None, *, zfm: float, cx: float,
                cy: float, width: int, height: int, max_r=None,
                match_thresh: float, max_s_rho: Tensor,
                match_num_min: Tensor, k_huber: float,
                min_mod: Tensor = None,
                vote_mask: Tensor = None) -> TryVelRotResult:
    """One robust residual/Jacobian evaluation at state(s) X [..., 6]."""
    V = X[..., :3]
    W = X[..., 3:]
    R0 = so3_exp(W)                                   # [..., 3, 3]

    def e(a):                                         # [...] -> [..., 1]
        return a[..., None]

    one = torch.ones_like(old.rho)
    zero = torch.zeros_like(old.rho)
    rho_safe = torch.where(old.valid, old.rho, one)
    Z0 = 1.0 / rho_safe
    X0 = torch.where(old.valid, old.px, zero) * Z0 / zfm
    Y0 = torch.where(old.valid, old.py, zero) * Z0 / zfm

    ptx = e(R0[..., 0, 0]) * X0 + e(R0[..., 0, 1]) * Y0 + \
        e(R0[..., 0, 2]) * Z0 + e(V[..., 0])
    pty = e(R0[..., 1, 0]) * X0 + e(R0[..., 1, 1]) * Y0 + \
        e(R0[..., 1, 2]) * Z0 + e(V[..., 1])
    ptz = e(R0[..., 2, 0]) * X0 + e(R0[..., 2, 1]) * Y0 + \
        e(R0[..., 2, 2]) * Z0 + e(V[..., 2])
    rho_p = 1.0 / ptz
    qx = ptx * zfm * rho_p
    qy = pty * zfm * rho_p
    pix = qx + cx
    piy = qy + cy

    gated = (old.s_rho > max_s_rho) | (old.m_num < match_num_min) | \
        (~old.valid)
    if min_mod is not None:
        gated = gated | (old.n_m < min_mod)

    xr = round_int(pix)
    yr = round_int(piy)
    oob = (xr < 1) | (yr < 1) | (xr >= width - 1) | (yr >= height - 1)

    lin = torch.clamp(yr, 0, height - 1) * width + \
        torch.clamp(xr, 0, width - 1)
    j = fv.ikl.reshape(-1)[lin]
    j_safe = torch.clamp(j, min=0)
    no_kl = j < 0
    fa = fv.attrs[j_safe]                             # [..., K, 8]

    c = e(torch.cos(W[..., 2].double()).to(W.dtype))
    s = e(torch.sin(W[..., 2].double()).to(W.dtype))
    gmx = c * old.gx - s * old.gy
    gmy = s * old.gx + c * old.gy
    f_gx = fa[..., 4]
    f_gy = fa[..., 5]
    p_n2 = old.n_m * old.n_m
    p_esc = gmx * f_gx + gmy * f_gy
    grad_fail = torch.abs(p_esc - p_n2) > match_thresh * p_n2
    miss = no_kl | grad_fail

    dx = pix - fa[..., 0]
    dy = piy - fa[..., 1]
    fux = fa[..., 2]
    fuy = fa[..., 3]
    fi = dx * fux + dy * fuy

    matched = (~gated) & (~oob) & (~miss)
    zk = torch.zeros_like(fi)
    dfx = torch.where(matched, fux, zk)
    dfy = torch.where(matched, fuy, zk)

    s_shape = torch.clamp(old.s_rho, max=1.0)
    qvel = zfm * dfx * e(V[..., 0]) + zfm * dfy * e(V[..., 1]) + \
        (qx * dfx + qy * dfy) * e(V[..., 2])
    q_self = torch.sqrt(torch.square(s_shape * qvel) + 1.0)
    q = q_self if q_frozen is None else q_frozen
    inv_q = 1.0 / q

    r = torch.where(matched, fi * inv_q, zk)
    abs_r = torch.abs(r)
    k = float(k_huber)
    inlier = matched & (abs_r <= k)
    cost_m = torch.clamp(r * r, max=k * k)
    w = torch.where(inlier, torch.ones_like(r), zk)

    cost = torch.where(gated, zk, torch.where(matched, cost_m,
                                              torch.full_like(r, k * k)))
    voter = old.valid if vote_mask is None else (old.valid & vote_mask)
    score = sum64(torch.where(voter, cost, zk), dim=-1)

    m_id_f = torch.where(matched, j, torch.full_like(j, -1))

    a = rho_p * zfm * dfx
    b = rho_p * zfm * dfy
    ct = rho_p * (qx * dfx + qy * dfy)
    sw = torch.sqrt(w) * inv_q
    J = torch.stack([a, b, -ct, -b * ptz - ct * pty, a * ptz + ct * ptx,
                     -a * pty + b * ptx], dim=-1) * sw[..., None]
    vm = voter & matched
    J = torch.where(vm[..., None], J, torch.zeros_like(J))
    fw = torch.where(vm, r * torch.sqrt(w), zk)

    JtJ = matmul(J.transpose(-1, -2), J)
    JtF = matmul(J.transpose(-1, -2), fw[..., None])[..., 0]
    return TryVelRotResult(score=score, JtJ=JtJ, JtF=JtF,
                           residual=torch.where(matched, fi, zk),
                           m_id_f=m_id_f, q_rho=q_self)


def _lm_damping_update(u, v, gain):
    fac = torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=0.33)
    return u * fac, torch.full_like(v, 2.0)


def _solve_lm(JtJ: Tensor, JtF: Tensor, u: Tensor) -> Tensor:
    eye = torch.eye(JtJ.shape[-1], dtype=JtJ.dtype, device=JtJ.device)
    A = JtJ + u[..., None, None] * eye
    return _solve64(A, -JtF)


def _pick(a: Tensor, i: Tensor) -> Tensor:
    """a[i] for a 0-d device index without a host read of i (indexing
    with a 0-d tensor converts it to a Python int)."""
    return torch.index_select(a, 0, i.reshape(1))[0]


def _where(c: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """where() of a per-batch condition [...] over [..., *] values."""
    return torch.where(c.reshape(c.shape + (1,) * (a.ndim - c.ndim)), a, b)


class MinimizerRVResult(NamedTuple):
    Vel: Tensor
    W0: Tensor
    RVel: Tensor      # covariance of V (slice of JtJ^-1)
    RW0: Tensor
    W_X: Tensor       # [6,6] information matrix (final JtJ)
    m_id_f: Tensor    # forward matches at the final state
    score: Tensor
    rel_error: Tensor
    rel_error_score: Tensor


def _lm_phase(ev, X0: Tensor, n_iter: int, tau: float):
    """LM over a batch of start states X0 [..., 6] with fixed iterations;
    returns (X, F, JtJ, JtF, m_id_f, eff, h, F_init)."""
    r = ev(X0)
    F_init = r.score
    F = r.score
    JtJ, JtF, m_id_f = r.JtJ, r.JtF, r.m_id_f
    u = tau * torch.amax(JtJ, dim=(-2, -1))
    v = torch.full_like(u, 2.0)
    X = X0
    eff = torch.zeros(F.shape, dtype=torch.int32, device=F.device)
    h = torch.zeros_like(X0)
    for _ in range(n_iter):
        h_new = _solve_lm(JtJ, JtF, u)
        Xn = X + h_new
        rn = ev(Xn)
        pred = 0.5 * sum64(h_new * (u[..., None] * h_new - JtF), dim=-1)
        gain = (F - rn.score) / pred
        acc = gain > 0
        X = _where(acc, Xn, X)
        F = torch.where(acc, rn.score, F)
        JtJ = _where(acc, rn.JtJ, JtJ)
        JtF = _where(acc, rn.JtF, JtF)
        m_id_f = _where(acc, rn.m_id_f, m_id_f)
        u_acc, v_acc = _lm_damping_update(u, v, gain)
        u = torch.where(acc, u_acc, u * v)
        v = torch.where(acc, v_acc, v * 2.0)
        eff = eff + acc.to(torch.int32)
        h = _where(acc, h_new, h)
    return X, F, JtJ, JtF, m_id_f, eff, h, F_init


def minimizer_rv_plain(Vel: Tensor, W0: Tensor, old: KeylineMap,
                       fv: FieldView, *, zfm: float, cx: float, cy: float,
                       width: int, height: int, max_r=None,
                       match_thresh: float, max_s_rho: Tensor,
                       match_num_min: Tensor, k_huber: float, iter_max: int,
                       init_iter: int, init_type: int = 2,
                       vote_mask: Tensor = None) -> MinimizerRVResult:
    """Levenberg-Marquardt over [V; W] (Minimizer_RV,
    global_tracker.cpp:578-819), noise shaping frozen at the prior: K3's
    plain version, in plain PyTorch ops."""
    tau = 1e-3
    kw = dict(zfm=zfm, cx=cx, cy=cy, width=width, height=height,
              match_thresh=match_thresh, max_s_rho=max_s_rho,
              match_num_min=match_num_min, k_huber=k_huber,
              vote_mask=vote_mask)

    prior_X = torch.cat([Vel, W0])
    q_frame = try_vel_rot(prior_X, old, fv, None, **kw).q_rho

    def ev(X):
        return try_vel_rot(X, old, fv, q_frame, **kw)

    if init_type == 0:
        X = torch.zeros_like(prior_X)
    elif init_type == 1:
        X = prior_X
    else:
        # warm start over a candidate batch: zero and prior inits
        # (global_tracker.cpp:644-751), then a 2x/4x/8x velocity ladder on
        # the refined base (see the JAX package for why)
        cands = torch.stack([torch.zeros_like(prior_X), prior_X])
        Xs, Fs = _lm_phase(ev, cands, init_iter, tau)[:2]
        base_X = torch.where(Fs[1] <= Fs[0], Xs[1], Xs[0])
        base_F = torch.where(Fs[1] <= Fs[0], Fs[1], Fs[0])
        rungs = torch.stack([torch.cat([base_X[:3] * sc, base_X[3:]])
                             for sc in (2.0, 4.0, 8.0)])
        Xr, Fr = _lm_phase(ev, rungs, init_iter, tau)[:2]
        rung_i = torch.argmin(Fr)
        take = _pick(Fr, rung_i) < 0.98 * base_F
        X = torch.where(take, _pick(Xr, rung_i), base_X)

    X, F, JtJ, JtF, m_id_f, eff, h, F0 = _lm_phase(ev, X, iter_max, tau)

    RRV = _inv64(JtJ)
    any_eff = eff > 0
    rel_error = torch.where(
        any_eff, torch.linalg.norm(h) / (torch.linalg.norm(X) + 1e-30),
        torch.full_like(F, 1e20))
    rel_error_score = torch.where(
        any_eff, F / torch.where(F0 > 0, F0, torch.ones_like(F0)),
        torch.full_like(F, 1e20))
    return MinimizerRVResult(
        Vel=X[:3], W0=X[3:], RVel=RRV[:3, :3], RW0=RRV[3:, 3:], W_X=JtJ,
        m_id_f=m_id_f, score=F, rel_error=rel_error,
        rel_error_score=rel_error_score)


# ---------------------------------------------------------------------------
# K3: the whole solver in one launch (csrc/pose_lm.cu)
# ---------------------------------------------------------------------------


class SolverMap(NamedTuple):
    """The fields of the old KeylineMap that the solver reads."""

    valid: Tensor
    px: Tensor
    py: Tensor
    rho: Tensor
    s_rho: Tensor
    m_num: Tensor
    gx: Tensor
    gy: Tensor
    n_m: Tensor


# K3's inputs, in the order of the C launcher and the op: (name, dtype,
# trailing shape, or None where it is the keyline count K)
_INPUTS = (("Vel", torch.float32, (3,)), ("W0", torch.float32, (3,)),
           ("valid", torch.bool, None), ("px", torch.float32, None),
           ("py", torch.float32, None), ("rho", torch.float32, None),
           ("s_rho", torch.float32, None), ("m_num", torch.int32, None),
           ("gx", torch.float32, None), ("gy", torch.float32, None),
           ("n_m", torch.float32, None), ("ikl", torch.int32, "HW"),
           ("attrs", torch.float32, "K8"), ("max_s_rho", torch.float32, ()),
           ("match_num_min", torch.int32, ()),
           ("vote_mask", torch.bool, None))
N_OUT = 63      # a lane's packed outputs (_unpack)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# pose_lm_launch: 16 inputs, the mid scratch, out, m_id_f; L, K, H, W,
# iter_max, init_iter, init_type, recip_div; zfm, inv_zfm, cx, cy,
# match_thresh, k, kk; stream
K3_ARGTYPES = [_P] * 19 + [_I] * 8 + [_F] * 7 + [_P]


def _unpack(packed: Tensor, m_id_f: Tensor) -> MinimizerRVResult:
    """A [..., N_OUT] row of K3's outputs as MinimizerRVResult (views)."""
    p = packed
    return MinimizerRVResult(
        Vel=p[..., 0:3], W0=p[..., 3:6],
        RVel=p[..., 6:15].unflatten(-1, (3, 3)),
        RW0=p[..., 15:24].unflatten(-1, (3, 3)),
        W_X=p[..., 24:60].unflatten(-1, (6, 6)), m_id_f=m_id_f,
        score=p[..., 60], rel_error=p[..., 61], rel_error_score=p[..., 62])


def _pack(r: MinimizerRVResult) -> Tuple[Tensor, Tensor]:
    return torch.cat([r.Vel, r.W0, r.RVel.reshape(-1), r.RW0.reshape(-1),
                      r.W_X.reshape(-1), r.score.reshape(1),
                      r.rel_error.reshape(1),
                      r.rel_error_score.reshape(1)]), r.m_id_f


def pose_launch(launch: Callable[..., int], tensors, stream, *, zfm: float,
                cx: float, cy: float, width: int, height: int,
                match_thresh: float, k_huber: float, iter_max: int,
                init_iter: int, init_type: int) -> Tuple[Tensor, Tensor]:
    """K3 through the C entry point `launch` (argument types K3_ARGTYPES)
    on `tensors`, the inputs in _INPUTS' order, each with the same leading
    lane axes (none for one lane; `vote_mask` may be None). Returns the
    packed outputs [..., N_OUT] and m_id_f [..., K]; raises on an input
    the kernel does not take, or if the launcher refuses.
    `minimizer_rv` passes the card's entry point; the tests a host build
    of the same source."""
    Vel = tensors[0]
    lanes = tuple(Vel.shape[:-1])
    L = math.prod(lanes)
    K = tensors[2].shape[-1] if tensors[2].ndim > len(lanes) else -1
    HW = (height, width)
    flat = []
    for (name, dtype, tail), t in zip(_INPUTS, tensors):
        if t is None and name == "vote_mask":
            flat.append(None)
            continue
        tail = {None: (K,), "HW": HW, "K8": (K, 8)}.get(tail, tail)
        if not isinstance(t, Tensor) or t.dtype != dtype:
            raise TypeError(f"minimizer_rv: {name} must be a {dtype} tensor")
        if t.device != Vel.device:
            raise ValueError(f"minimizer_rv: {name} is on {t.device}, Vel "
                             f"on {Vel.device}")
        if tuple(t.shape) != lanes + tuple(tail):
            raise ValueError(f"minimizer_rv: {name} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"{lanes + tuple(tail)}")
        flat.append(t.contiguous())
    if K < 1 or L < 1:
        raise ValueError(f"minimizer_rv: needs K >= 1 slots and a lane, "
                         f"got K={K}, lanes {lanes}")
    dev = Vel.device
    mid = torch.empty((L, K), dtype=torch.int32, device=dev)
    out = torch.empty(lanes + (N_OUT,), dtype=torch.float32, device=dev)
    m_id_f = torch.empty(lanes + (K,), dtype=torch.int32, device=dev)
    inv_zfm = float(np.float32(1.0) / np.float32(zfm))
    err = launch(*[0 if t is None else t.data_ptr() for t in flat],
                 mid.data_ptr(), out.data_ptr(),
                 m_id_f.data_ptr(), L, K, height, width, iter_max,
                 init_iter, init_type, int(dev.type == "cuda"), zfm,
                 inv_zfm, cx, cy, match_thresh, k_huber, k_huber * k_huber,
                 stream)
    if err != 0:
        raise RuntimeError(f"pose_lm kernel launch failed: cudaError {err}")
    return out, m_id_f


@functools.cache
def _launcher():
    """K3's C entry point, built and loaded at first use."""
    fn = cuda_build.library("pose_lm").pose_lm_launch
    fn.argtypes = K3_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _plain(tensors, **kw) -> Tuple[Tensor, Tensor]:
    """The plain version on one lane's inputs (_INPUTS' order), packed."""
    Vel, W0, *fields = tensors[:11]
    ikl, attrs, max_s_rho, match_num_min, vote_mask = tensors[11:]
    return _pack(minimizer_rv_plain(
        Vel, W0, SolverMap(*fields), FieldView(ikl=ikl, attrs=attrs),
        max_s_rho=max_s_rho, match_num_min=match_num_min,
        vote_mask=vote_mask, **kw))


@torch.library.custom_op("rebvo_tpu_torch::pose_lm", mutates_args=())
def _pose_op(Vel: Tensor, W0: Tensor, valid: Tensor, px: Tensor,
             py: Tensor, rho: Tensor, s_rho: Tensor, m_num: Tensor,
             gx: Tensor, gy: Tensor, n_m: Tensor, ikl: Tensor,
             attrs: Tensor, max_s_rho: Tensor, match_num_min: Tensor,
             vote_mask: Optional[Tensor], zfm: float, cx: float, cy: float,
             width: int, height: int, match_thresh: float, k_huber: float,
             iter_max: int, init_iter: int, init_type: int
             ) -> Tuple[Tensor, Tensor]:
    """K3 on the CUDA device, its plain version on the CPU: the packed
    outputs [..., N_OUT] and m_id_f [..., K] of every lane (leading axes
    of Vel)."""
    tensors = (Vel, W0, valid, px, py, rho, s_rho, m_num, gx, gy, n_m, ikl,
               attrs, max_s_rho, match_num_min, vote_mask)
    kw = dict(zfm=zfm, cx=cx, cy=cy, width=width, height=height,
              match_thresh=match_thresh, k_huber=k_huber,
              iter_max=iter_max, init_iter=init_iter, init_type=init_type)
    if Vel.device.type == "cpu":
        lanes = Vel.shape[:-1]
        if not lanes:
            return _plain(tensors, **kw)
        flat = [None if t is None else t.reshape((-1,) + t.shape[len(lanes):])
                for t in tensors]
        outs = [_plain([None if t is None else t[i] for t in flat], **kw)
                for i in range(flat[0].shape[0])]
        return tuple(torch.stack(o).reshape(lanes + o[0].shape)
                     for o in zip(*outs))
    if Vel.device.type != "cuda":
        raise ValueError(f"minimizer_rv: unsupported device {Vel.device}")
    out = pose_launch(_launcher(), tensors,
                      torch.cuda.current_stream(Vel.device).cuda_stream,
                      **kw)
    minimizer_rv.launches += 1
    obs.count("pose.kernel")
    return out


@_pose_op.register_fake
def _pose_fake(Vel, W0, valid, *rest):
    lanes = Vel.shape[:-1]
    return (Vel.new_empty(lanes + (N_OUT,)),
            valid.new_empty(valid.shape, dtype=torch.int32))


_N_TENSORS = len(_INPUTS)


def _pose_vmap(info, in_dims, *args):
    """vmap rule of K3: every lane's inputs in one call (one launch on the
    card), an unbatched input expanded over the lanes."""
    B = info.batch_size
    ts = [t if t is None else (t.movedim(d, 0) if d is not None
                               else t.expand((B,) + t.shape))
          for t, d in zip(args[:_N_TENSORS], in_dims[:_N_TENSORS])]
    return _pose_op(*ts, *args[_N_TENSORS:]), (0, 0)


torch.library.register_vmap("rebvo_tpu_torch::pose_lm", _pose_vmap)


def minimizer_rv(Vel: Tensor, W0: Tensor, old: KeylineMap, fv: FieldView,
                 *, zfm: float, cx: float, cy: float, width: int,
                 height: int, max_r=None, match_thresh: float,
                 max_s_rho: Tensor, match_num_min: Tensor, k_huber: float,
                 iter_max: int, init_iter: int, init_type: int = 2,
                 vote_mask: Tensor = None) -> MinimizerRVResult:
    """Levenberg-Marquardt over [V; W] (Minimizer_RV,
    global_tracker.cpp:578-819), noise shaping frozen at the prior. On
    CUDA tensors one launch of K3, which adds one to
    `minimizer_rv.launches` and to the counter `pose.kernel`; on CPU
    tensors its plain version, `minimizer_rv_plain`. `max_s_rho` and
    `match_num_min` are 0-d tensors; the fields returned are views of one
    packed row."""
    packed, m_id_f = _pose_op(
        Vel, W0, old.valid, old.px, old.py, old.rho, old.s_rho, old.m_num,
        old.gx, old.gy, old.n_m, fv.ikl, fv.attrs,
        max_s_rho.to(torch.float32), match_num_min.to(torch.int32),
        vote_mask, float(zfm), float(cx), float(cy), int(width),
        int(height), float(match_thresh), float(k_huber), int(iter_max),
        int(init_iter), int(init_type))
    return _unpack(packed, m_id_f)


minimizer_rv.launches = 0


class MinimizerVResult(NamedTuple):
    Vel: Tensor
    RVel: Tensor
    m_id_f: Tensor
    score: Tensor


def minimizer_v(Vel: Tensor, old: KeylineMap, fv: FieldView, *,
                zfm: float, cx: float, cy: float, width: int, height: int,
                max_r=None, match_thresh: float, max_s_rho: Tensor,
                match_num_min: Tensor, k_huber: float, min_mod: Tensor,
                iter_max: int, vote_mask: Tensor = None
                ) -> MinimizerVResult:
    """Translation-only LM (Minimizer_V / TryVel,
    global_tracker.cpp:829-1093), restricted to the V block."""
    tau = 1e-3
    kw = dict(zfm=zfm, cx=cx, cy=cy, width=width, height=height,
              match_thresh=match_thresh, max_s_rho=max_s_rho,
              match_num_min=match_num_min, k_huber=k_huber, min_mod=min_mod,
              vote_mask=vote_mask)
    prior_X = torch.cat([Vel, torch.zeros_like(Vel)])
    q_frame = try_vel_rot(prior_X, old, fv, None, **kw).q_rho

    def ev(V):
        return try_vel_rot(torch.cat([V, torch.zeros_like(V)], dim=-1),
                           old, fv, q_frame, **kw)

    def lm_phase(V0, n_iter):
        r = ev(V0)
        F = r.score
        JtJ = r.JtJ[..., :3, :3]
        JtF = r.JtF[..., :3]
        m_id_f = r.m_id_f
        u = tau * torch.amax(JtJ, dim=(-2, -1))
        v = torch.full_like(u, 2.0)
        V = V0
        for _ in range(n_iter):
            h = _solve_lm(JtJ, JtF, u)
            Vn = V + h
            rn = ev(Vn)
            pred = 0.5 * sum64(h * (u[..., None] * h - JtF), dim=-1)
            gain = (F - rn.score) / pred
            acc = gain > 0
            V = _where(acc, Vn, V)
            F = torch.where(acc, rn.score, F)
            JtJ = _where(acc, rn.JtJ[..., :3, :3], JtJ)
            JtF = _where(acc, rn.JtF[..., :3], JtF)
            m_id_f = _where(acc, rn.m_id_f, m_id_f)
            u_acc, v_acc = _lm_damping_update(u, v, gain)
            u = torch.where(acc, u_acc, u * v)
            v = torch.where(acc, v_acc, v * 2.0)
        return V, F, JtJ, JtF, m_id_f

    V0, F0_, *_ = lm_phase(Vel, 2)
    rungs = torch.stack([V0 * sc for sc in (2.0, 4.0, 8.0)])
    Vr, Fr = lm_phase(rungs, 2)[:2]
    rung_i = torch.argmin(Fr)
    take = _pick(Fr, rung_i) < 0.98 * F0_
    V = torch.where(take, _pick(Vr, rung_i), V0)
    V, F, JtJ, JtF, m_id_f = lm_phase(V, iter_max)
    RVel = _inv64(JtJ)
    return MinimizerVResult(Vel=V, RVel=RVel, m_id_f=m_id_f, score=F)
