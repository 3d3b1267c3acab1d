"""Online keyframe-relative tracking inside the step (PyTorch counterpart
of rebvo_tpu/frontend/kf_tracking.py; reference
src/rebvo/rebvo_second_t.cpp:429-444, :591-596 and the kernels of
src/mtracklib/kfvo.cpp:739-1041).

The reference's data-dependent chain walks are fixed-step vectorised
coordinate descent over the whole keyline batch, and augmentation is
bounded parallel label propagation followed by a global epipolar prune.
The JAX package's `fori_loop`s are Python loops with the same fixed
counts.

`correct_and_augment`'s K-wide body (both directions' walks, the
augmentation, the inversion, the prunes and the counts) is, on CUDA
tensors, one launch of K4, the hand-written kernel `csrc/kf_correct.cu`
(built by `nvcc` at first use), through the custom op
`rebvo_tpu_torch::kf_correct`, whose vmap rule hands every vmapped lane
to that one launch. On CPU tensors the op runs the plain version,
`_body_plain` (lane by lane under vmap). There is no fallback from the
card to the plain version. The block's scalars (the essential matrices,
the baseline tests) stay plain ops.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Tuple

import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.core.geometry import skew, so3_exp
from rebvo_tpu_torch.core.numerics import matmul, sum64
from rebvo_tpu_torch.frontend.state import KeylineMap, select_map
from rebvo_tpu_torch.kernels import cuda_build

Tensor = torch.Tensor

BIG_D = 1e9


class KFCarry(NamedTuple):
    """Device-resident active keyframe (the reference's kf_list.back());
    `klm.m_id_f` holds the KF -> current-frame forward matches."""

    klm: KeylineMap
    Pose: Tensor       # [3,3] keyframe global rotation
    Pos: Tensor        # [3] keyframe global position
    count: Tensor      # int32 keyframes pushed so far (0 = none yet)
    age: Tensor        # int32 frames since this keyframe was pushed
    G: Tensor          # cumulative map-gauge factor at capture

    @staticmethod
    def empty(K: int, dtype=torch.float32, device="cuda") -> "KFCarry":
        return KFCarry(
            klm=KeylineMap.empty(K, dtype=dtype, device=device),
            Pose=torch.eye(3, dtype=dtype, device=device),
            Pos=torch.zeros((3,), dtype=dtype, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
            age=torch.zeros((), dtype=torch.int32, device=device),
            G=torch.ones((), dtype=dtype, device=device))


class KFTrackResult(NamedTuple):
    kf: KFCarry
    klm: KeylineMap
    Pose: Tensor
    Pos: Tensor
    fow_m: Tensor
    back_m: Tensor
    saved: Tensor
    align_ok: Tensor


def invert_matches(m_id: Tensor, valid: Tensor, K_old: int) -> Tensor:
    """fowMatch of buildForwardMatch (kfvo.cpp:742-753): for each OLD
    keyline the NEW keyline that back-matched to it (-1 = none; the
    highest new index wins, the reference's last-writer-wins order)."""
    K_new = m_id.shape[-1]
    has = (m_id >= 0) & valid
    tgt = torch.where(has, m_id, torch.full_like(m_id, K_old)).to(torch.int64)
    inv = torch.full((K_old + 1,), -1, dtype=torch.int32, device=m_id.device)
    inv = inv.scatter_reduce(0, tgt, torch.arange(K_new, dtype=torch.int32,
                                                  device=m_id.device),
                             reduce="amax", include_self=True)
    return inv[:K_old]


def build_forward_match(kf_m_id_f: Tensor, kf_valid: Tensor,
                        inv_old_to_new: Tensor) -> Tensor:
    """Re-point the keyframe's forward matches through the old->new
    inversion (buildForwardMatch, kfvo.cpp:755-766)."""
    stepped = inv_old_to_new[torch.clamp(kf_m_id_f, min=0)]
    return torch.where((kf_m_id_f >= 0) & kf_valid, stepped,
                       torch.full_like(stepped, -1))


def essential_matrix(R: Tensor, t: Tensor) -> Tensor:
    """E = R [t]x (kfvo.cpp:894-896)."""
    return matmul(R, skew(t))


def _epipolar_dist(qx, qy, E, zfm, tgt_px, tgt_py):
    """Closure dist(j): distance of target keyline j to each query's
    epipolar line (stereoCorrect core, kfvo.cpp:810-817)."""
    ex = E[0, 0] * qx + E[0, 1] * qy + E[0, 2] * zfm
    ey = E[1, 0] * qx + E[1, 1] * qy + E[1, 2] * zfm
    ez = E[2, 0] * qx + E[2, 1] * qy + E[2, 2] * zfm
    n = torch.sqrt(ex * ex + ey * ey)
    bad = n < 1e-12
    n = torch.where(bad, torch.ones_like(n), n)
    r0 = ex / n
    r1 = ey / n
    r2 = ez * zfm / n

    def dist(j):
        js = torch.clamp(j, min=0)
        d = torch.abs(tgt_px[js] * r0 + tgt_py[js] * r1 + r2)
        return torch.where((j >= 0) & (~bad), d, torch.full_like(d, BIG_D))

    return dist


def chain_correct(qx: Tensor, qy: Tensor, m_id: Tensor, tgt: KeylineMap,
                  E: Tensor, zfm: float, steps: int) -> Tuple[Tensor, Tensor]:
    """Slide each match along the target map's edge chain to a chain-local
    minimum of epipolar distance (stereoCorrect, kfvo.cpp:820-885) with a
    fixed step budget. Returns (corrected m_id, final distance)."""
    dist = _epipolar_dist(qx, qy, E, zfm, tgt.px, tgt.py)
    m = m_id
    for _ in range(steps):
        d0 = dist(m)
        ms = torch.clamp(m, min=0)
        neg = torch.full_like(m, -1)
        nn = torch.where(m >= 0, tgt.n_id[ms], neg)
        pp = torch.where(m >= 0, tgt.p_id[ms], neg)
        dn = dist(nn)
        dp = dist(pp)
        go_n = (dn < d0) & (dn <= dp)
        go_p = (dp < d0) & (dp < dn)
        m = torch.where(go_n, nn, torch.where(go_p, pp, m))
    return m, dist(m)


def augment_matches(m_id: Tensor, src_p_id: Tensor, src_n_id: Tensor,
                    iters: int) -> Tensor:
    """Propagate matches along the SOURCE map's edge chains onto unmatched
    neighbours (the 'augmentate' halves of kfvo.cpp:920-1041)."""
    m = m_id
    for _ in range(iters):
        for link in (src_p_id, src_n_id):
            ls = torch.clamp(link, min=0)
            cand = torch.where(link >= 0, m[ls], torch.full_like(m, -1))
            m = torch.where((m < 0) & (cand >= 0), cand, m)
    return m


def kf_relative_pose(kf: KFCarry, Pose: Tensor, Pos: Tensor):
    """(R, t) mapping keyframe camera points into the current frame."""
    return matmul(Pose.T, kf.Pose), matmul(Pose.T, kf.Pos - Pos)


class _Target(NamedTuple):
    """The fields of a target map that chain_correct reads."""

    px: Tensor
    py: Tensor
    p_id: Tensor
    n_id: Tensor


def _scalars(kf: KFCarry, klm: KeylineMap, Pose: Tensor, Pos: Tensor,
             zfm: float, min_baseline_px: float):
    """The block's per-frame scalars: the backward and forward essential
    matrices and baseline tests (E_b, E_f, strong_b, strong_f)."""
    nv = torch.clamp(torch.sum(klm.valid, dtype=torch.int32), min=1)
    rho_mean = sum64(torch.where(klm.valid, klm.rho,
                                 torch.zeros_like(klm.rho))) / nv
    # backward direction: frame keylines -> KF map
    R_b = matmul(kf.Pose.T, Pose)
    t_b = matmul(Pose.T, kf.Pos - Pos)
    E_b = essential_matrix(R_b, t_b)
    strong_b = zfm * torch.linalg.norm(t_b) * rho_mean > min_baseline_px
    # forward direction: KF keylines -> frame map
    R_f = matmul(Pose.T, kf.Pose)
    t_f = matmul(kf.Pose.T, Pos - kf.Pos)
    E_f = essential_matrix(R_f, t_f)
    strong_f = zfm * torch.linalg.norm(t_f) * rho_mean > min_baseline_px
    return E_b, E_f, strong_b, strong_f


def _fields(klm: KeylineMap, kf_klm: KeylineMap):
    """The maps' fields K4 reads, in _INPUTS' order after the scalars."""
    return (klm.px, klm.py, klm.p_id, klm.n_id, klm.valid, klm.m_id_kf,
            klm.m_id, kf_klm.px, kf_klm.py, kf_klm.p_id, kf_klm.n_id,
            kf_klm.valid, kf_klm.m_id_f)


def _body_plain(E_b, E_f, strong_b, strong_f, px, py, p_id, n_id, valid,
                m_id_kf, m_id, kf_px, kf_py, kf_p_id, kf_n_id, kf_valid,
                kf_m_id_f, *, zfm: float, dist_thresh: float,
                chain_steps: int, aug_iters: int):
    """K4's plain version on one lane: the block's K-wide body given its
    scalars. Returns (m_f, m_kf, [fow_m, back_m])."""
    neg = torch.full_like(m_id_kf, -1)
    kf_tgt = _Target(kf_px, kf_py, kf_p_id, kf_n_id)
    frame_tgt = _Target(px, py, p_id, n_id)

    # backward direction: frame keylines -> KF map
    m_raw = torch.where(valid, m_id_kf, neg)
    m_kf, _ = chain_correct(px, py, m_id_kf, kf_tgt, E_b, zfm, chain_steps)
    m_kf = augment_matches(m_kf, p_id, n_id, aug_iters)
    m_kf, d_b = chain_correct(px, py, m_kf, kf_tgt, E_b, zfm, chain_steps)
    m_kf = torch.where((d_b > dist_thresh) | (~valid), neg, m_kf)
    m_kf = torch.where(strong_b, m_kf, m_raw)
    back_m = torch.sum(m_kf >= 0, dtype=torch.int32)

    # forward direction: KF keylines -> frame map, rebuilt each frame
    # through the inverted new->old back matches (kfvo.cpp:739-771)
    inv_old_to_new = invert_matches(m_id, valid, m_id.shape[-1])
    m_f = build_forward_match(kf_m_id_f, kf_valid, inv_old_to_new)
    m_f_raw = m_f
    m_f, _ = chain_correct(kf_px, kf_py, m_f, frame_tgt, E_f, zfm,
                           chain_steps)
    m_f = augment_matches(m_f, kf_p_id, kf_n_id, aug_iters)
    m_f, d_f = chain_correct(kf_px, kf_py, m_f, frame_tgt, E_f, zfm,
                             chain_steps)
    m_f = torch.where((d_f > dist_thresh) | (~kf_valid),
                      torch.full_like(m_f, -1), m_f)
    m_f = torch.where(strong_f, m_f, m_f_raw)
    fow_m = torch.sum(m_f >= 0, dtype=torch.int32)
    return m_f, m_kf, torch.stack([fow_m, back_m])


def correct_and_augment_plain(kf: KFCarry, klm: KeylineMap, Pose: Tensor,
                              Pos: Tensor, zfm: float, *,
                              dist_thresh: float, chain_steps: int,
                              aug_iters: int, min_baseline_px: float = 2.0):
    """The per-frame maintenance block (rebvo_second_t.cpp:429-444) in
    plain PyTorch ops: K4's plain version, with correct_and_augment's
    signature and results."""
    m_f, m_kf, counts = _body_plain(
        *_scalars(kf, klm, Pose, Pos, zfm, min_baseline_px),
        *_fields(klm, kf.klm), zfm=zfm, dist_thresh=dist_thresh,
        chain_steps=chain_steps, aug_iters=aug_iters)
    return m_f, m_kf, counts[0], counts[1]


# ---------------------------------------------------------------------------
# K4: the K-wide body in one launch (csrc/kf_correct.cu)
# ---------------------------------------------------------------------------

# K4's inputs, in the order of the C launcher and the op: (name, dtype,
# trailing shape, or None where it is the keyline count K)
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_INPUTS = (("E_b", _F32, (3, 3)), ("E_f", _F32, (3, 3)),
           ("strong_b", _BOOL, ()), ("strong_f", _BOOL, ()),
           ("px", _F32, None), ("py", _F32, None), ("p_id", _I32, None),
           ("n_id", _I32, None), ("valid", _BOOL, None),
           ("m_id_kf", _I32, None), ("m_id", _I32, None),
           ("kf_px", _F32, None), ("kf_py", _F32, None),
           ("kf_p_id", _I32, None), ("kf_n_id", _I32, None),
           ("kf_valid", _BOOL, None), ("kf_m_id_f", _I32, None))
_N_TENSORS = len(_INPUTS)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kf_correct_launch: 17 inputs, m_f, m_kf, counts; L, K, chain_steps,
# aug_iters; zfm, dist_thresh; stream
K4_ARGTYPES = [_P] * 20 + [_I] * 4 + [_F] * 2 + [_P]


def kf_launch(launch: Callable[..., int], tensors, stream, *, zfm: float,
              dist_thresh: float, chain_steps: int, aug_iters: int
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """K4 through its C entry point `launch` (argument types K4_ARGTYPES)
    on `tensors`, the inputs in _INPUTS' order, each with the same leading
    lane axes (none for one lane). Returns m_f, m_kf [..., K] and the
    counts [..., 2] (fow_m, back_m); raises on an input the kernel does
    not take, or if the launcher refuses. The wrapper passes the card's
    entry point; the tests a host build of the same source."""
    who = "correct_and_augment"
    if len(tensors) != _N_TENSORS:
        raise ValueError(f"{who}: takes {_N_TENSORS} inputs, got "
                         f"{len(tensors)}")
    E_b = tensors[0]
    if not isinstance(E_b, Tensor) or E_b.ndim < 2:
        raise TypeError(f"{who}: E_b must be a [..., 3, 3] tensor")
    lanes = tuple(E_b.shape[:-2])
    px = tensors[4]
    K = px.shape[-1] if isinstance(px, Tensor) and px.ndim > len(lanes) \
        else -1
    flat = []
    for (name, dtype, tail), t in zip(_INPUTS, tensors):
        tail = (K,) if tail is None else tail
        if not isinstance(t, Tensor) or t.dtype != dtype:
            raise TypeError(f"{who}: {name} must be a {dtype} tensor")
        if t.device != E_b.device:
            raise ValueError(f"{who}: {name} is on {t.device}, E_b on "
                             f"{E_b.device}")
        if tuple(t.shape) != lanes + tuple(tail):
            raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                             f"expected {lanes + tuple(tail)}")
        flat.append(t.contiguous())
    L = math.prod(lanes)
    if K < 1 or L < 1:
        raise ValueError(f"{who}: needs K >= 1 slots and a lane, got "
                         f"K={K}, lanes {lanes}")
    dev = E_b.device
    m_f = torch.empty(lanes + (K,), dtype=torch.int32, device=dev)
    m_kf = torch.empty(lanes + (K,), dtype=torch.int32, device=dev)
    counts = torch.empty(lanes + (2,), dtype=torch.int32, device=dev)
    err = launch(*[t.data_ptr() for t in flat], m_f.data_ptr(),
                 m_kf.data_ptr(), counts.data_ptr(), L, K, chain_steps,
                 aug_iters, zfm, dist_thresh, stream)
    if err != 0:
        raise RuntimeError(f"kf_correct kernel launch failed: cudaError "
                           f"{err}")
    return m_f, m_kf, counts


@functools.cache
def _launcher():
    """K4's C entry point, built and loaded at first use."""
    fn = cuda_build.library("kf_correct").kf_correct_launch
    fn.argtypes = K4_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("rebvo_tpu_torch::kf_correct", mutates_args=())
def _kf_op(E_b: Tensor, E_f: Tensor, strong_b: Tensor, strong_f: Tensor,
           px: Tensor, py: Tensor, p_id: Tensor, n_id: Tensor,
           valid: Tensor, m_id_kf: Tensor, m_id: Tensor, kf_px: Tensor,
           kf_py: Tensor, kf_p_id: Tensor, kf_n_id: Tensor,
           kf_valid: Tensor, kf_m_id_f: Tensor, zfm: float,
           dist_thresh: float, chain_steps: int, aug_iters: int
           ) -> Tuple[Tensor, Tensor, Tensor]:
    """K4 on the CUDA device, its plain version on the CPU: m_f, m_kf
    [..., K] and the counts [..., 2] of every lane (leading axes of
    E_b)."""
    tensors = (E_b, E_f, strong_b, strong_f, px, py, p_id, n_id, valid,
               m_id_kf, m_id, kf_px, kf_py, kf_p_id, kf_n_id, kf_valid,
               kf_m_id_f)
    kw = dict(zfm=zfm, dist_thresh=dist_thresh, chain_steps=chain_steps,
              aug_iters=aug_iters)
    if E_b.device.type == "cpu":
        lanes = E_b.shape[:-2]
        if not lanes:
            return _body_plain(*tensors, **kw)
        flat = [t.reshape((-1,) + t.shape[len(lanes):]) for t in tensors]
        outs = [_body_plain(*[t[i] for t in flat], **kw)
                for i in range(flat[0].shape[0])]
        return tuple(torch.stack(o).reshape(lanes + o[0].shape)
                     for o in zip(*outs))
    if E_b.device.type != "cuda":
        raise ValueError(f"correct_and_augment: unsupported device "
                         f"{E_b.device}")
    out = kf_launch(_launcher(), tensors,
                    torch.cuda.current_stream(E_b.device).cuda_stream, **kw)
    correct_and_augment.launches += 1
    obs.count("kf.kernel")
    return out


@_kf_op.register_fake
def _kf_fake(E_b, E_f, strong_b, strong_f, px, *rest):
    lanes = E_b.shape[:-2]
    K = px.shape[-1]
    i32 = dict(dtype=torch.int32)
    return (px.new_empty(lanes + (K,), **i32),
            px.new_empty(lanes + (K,), **i32),
            px.new_empty(lanes + (2,), **i32))


def _kf_vmap(info, in_dims, *args):
    """vmap rule of K4: every lane's inputs in one call (one launch on the
    card), an unbatched input expanded over the lanes."""
    B = info.batch_size
    ts = [t.movedim(d, 0) if d is not None else t.expand((B,) + t.shape)
          for t, d in zip(args[:_N_TENSORS], in_dims[:_N_TENSORS])]
    return _kf_op(*ts, *args[_N_TENSORS:]), (0, 0, 0)


torch.library.register_vmap("rebvo_tpu_torch::kf_correct", _kf_vmap)


def correct_and_augment(kf: KFCarry, klm: KeylineMap, Pose: Tensor,
                        Pos: Tensor, zfm: float, *, dist_thresh: float,
                        chain_steps: int, aug_iters: int,
                        min_baseline_px: float = 2.0):
    """The per-frame maintenance block (rebvo_second_t.cpp:429-444):
    forward chains through the inverted back matches, epipolar correct +
    augment + prune in both directions, skipped below a degenerate
    baseline. Returns (kf m_id_f, frame m_id_kf, fow_m, back_m). The
    scalars are plain ops; the K-wide body is, on CUDA tensors, one launch
    of K4, which adds one to `correct_and_augment.launches` and to the
    counter `kf.kernel`, and on CPU tensors its plain version
    (`correct_and_augment_plain` computes the same in plain ops alone).
    fow_m and back_m are views of one counts tensor."""
    m_f, m_kf, counts = _kf_op(
        *_scalars(kf, klm, Pose, Pos, zfm, min_baseline_px),
        *_fields(klm, kf.klm), float(zfm), float(dist_thresh),
        int(chain_steps), int(aug_iters))
    return m_f, m_kf, counts[..., 0], counts[..., 1]


correct_and_augment.launches = 0


def track_keyframe(kf: KFCarry, klm: KeylineMap, fv, Pose: Tensor,
                   Pos: Tensor, K_scale: Tensor, kl_num: Tensor,
                   s_rho_q: Tensor, enabled: Tensor, G_gauge: Tensor, *,
                   cam, params) -> KFTrackResult:
    """One frame of online keyframe tracking (the whole TrackKeyFrames
    block); `enabled` gates it on the frame's estimation health."""
    p = params
    dt = Pose.dtype
    dev = Pose.device
    zfm = cam.zfm

    have_kf = kf.count > 0
    run = have_kf & enabled

    m_f, m_kf, fow_m, back_m = correct_and_augment(
        kf, klm, Pose, Pos, zfm, dist_thresh=p.KFDistThresh,
        chain_steps=p.KFChainSteps, aug_iters=p.KFAugIters,
        min_baseline_px=p.KFMinBaselinePx)
    m_f = torch.where(run, m_f, torch.where(have_kf, kf.klm.m_id_f,
                                            torch.full_like(m_f, -1)))
    m_kf = torch.where(run, m_kf, torch.where(have_kf, klm.m_id_kf,
                                              torch.full_like(m_kf, -1)))
    fow_m = torch.where(run, fow_m, torch.zeros_like(fow_m))
    back_m = torch.where(run, back_m, torch.zeros_like(back_m))

    if not p.KFReAnchor:
        return _finish(kf, klm, m_f, m_kf, Pose, Pos, fow_m, back_m, kl_num,
                       enabled, run, have_kf,
                       torch.zeros((), dtype=torch.bool, device=dev),
                       G_gauge, params=p)

    from rebvo_tpu_torch.backend.kfvo import align_to_keyframe
    R_prior, t_prior = kf_relative_pose(kf, Pose, Pos)
    Ks = torch.clamp(K_scale, min=1e-12)
    cf = 1.0 / (Ks * torch.clamp(kf.G, min=1e-12))
    ares = align_to_keyframe(
        kf.klm, fv, R_prior, t_prior * cf, zfm=zfm, cx=cam.cx, cy=cam.cy,
        width=cam.width, height=cam.height, max_s_rho=s_rho_q,
        match_thresh=p.TrackerMatchThresh, k_huber=p.ReweigthDistance,
        iter_max=p.TrackerIterNum, init_iter=p.TrackerInitIterNum)
    # innovation chi^2 acceptance (see the JAX package)
    dW = ares.W0
    dV = ares.Vel
    finite = torch.all(torch.isfinite(dW)) & torch.all(torch.isfinite(dV)) & \
        torch.all(torch.isfinite(ares.RVel)) & \
        torch.all(torch.isfinite(ares.RW0))
    age_f = torch.clamp(kf.age, min=1).to(dt)
    q = torch.cat([
        torch.ones(3, dtype=dt, device=dev) * torch.square(
            p.KFDriftTransStd * cf),
        torch.full((3,), p.KFDriftRotStd ** 2, dtype=dt, device=dev)]) * age_f
    S = torch.block_diag(ares.RVel, ares.RW0) + torch.diag(q)
    dX = torch.cat([dV, dW])
    chi2 = matmul(dX, torch.linalg.solve_ex(S, dX)[0])
    CHI2_6_999 = 22.458                       # chi^2 6-dof 0.999 quantile
    conditioned = (torch.trace(ares.RW0) < p.KFAlignRotUncertMax ** 2) & \
        (torch.trace(ares.RVel) < torch.square(p.KFAlignTransUncertMax * cf))
    align_ok = run & finite & conditioned & (chi2 < CHI2_6_999) & \
        (back_m >= p.GlobalMatchThreshold)
    gain = matmul(torch.diag(q), torch.linalg.inv_ex(S)[0])
    dX_app = matmul(gain, dX)
    dR_b = so3_exp(dX_app[3:])
    R_b = matmul(dR_b, R_prior)
    t_b = matmul(dR_b, t_prior * cf) + dX_app[:3]
    Pose_kf = matmul(kf.Pose, R_b.T)
    Pos_kf = kf.Pos - matmul(Pose_kf, t_b / cf)
    Pose = torch.where(align_ok, Pose_kf, Pose)
    Pos = torch.where(align_ok, Pos_kf, Pos)
    return _finish(kf, klm, m_f, m_kf, Pose, Pos, fow_m, back_m, kl_num,
                   enabled, run, have_kf, align_ok, G_gauge, params=p)


def _finish(kf: KFCarry, klm: KeylineMap, m_f: Tensor, m_kf: Tensor,
            Pose: Tensor, Pos: Tensor, fow_m: Tensor, back_m: Tensor,
            kl_num: Tensor, enabled: Tensor, run: Tensor, have_kf: Tensor,
            align_ok: Tensor, G_gauge: Tensor, *, params) -> KFTrackResult:
    """Keyframe switch + carry update (rebvo_second_t.cpp:591-596)."""
    p = params
    dt = Pose.dtype
    limit = torch.clamp(kl_num, max=p.TrackPoints).to(dt) * p.KFSavePercent
    # the initial keyframe is also gated on estimation health
    save = (enabled & ~have_kf) | (run & (back_m.to(dt) < limit))

    ar = torch.arange(klm.K, dtype=torch.int32, device=Pose.device)
    neg = torch.full_like(ar, -1)
    ident = torch.where(klm.valid, ar, neg)
    # resetForwardMatch (kfvo.cpp:774-781): identity matches, rho0 backup
    new_kf_klm = klm._replace(m_id_f=ident, m_id_kf=ident,
                              rho0=klm.rho, s_rho0=klm.s_rho)
    kf_klm = select_map(save, new_kf_klm, kf.klm._replace(m_id_f=m_f))
    kf_out = KFCarry(
        klm=kf_klm,
        Pose=torch.where(save, Pose, kf.Pose),
        Pos=torch.where(save, Pos, kf.Pos),
        count=kf.count + save.to(torch.int32),
        age=torch.where(save, torch.zeros_like(kf.age), kf.age + 1),
        G=torch.where(save, G_gauge, kf.G))
    # resetKFMatch (kfvo.cpp:783-787) on the frame map when saved
    klm_out = klm._replace(m_id_kf=torch.where(save, ident, m_kf))
    return KFTrackResult(kf=kf_out, klm=klm_out, Pose=Pose, Pos=Pos,
                         fow_m=fow_m, back_m=back_m, saved=save,
                         align_ok=align_ok)
