"""The stage `vo.match_depth`'s K-wide body: K5, two hand-written CUDA
kernels (`csrc/match_depth.cu`), and their plain versions.

    m = md_match(old, new, field_img, V, P_V, nan_fail, cam=cam,
                 params=p, m_id_f=m_id_f, W=W)       # mono (or R0=, R=)
    d = md_depth(m.new, V, nan_fail, m.nmatch, frame_count, P_Kp, cam=cam,
                 params=p, rescale=True)             # False: stereo

`md_match` is the forward transfer of `matching.forward_match` along the
pose solver's `m_id_f` (when given), the forward rotation of the old map
by R0 (`so3_exp(W)`, or the caller's R0 with its back rotation R), and
`matching.directed_matching_field` against the rotated old map; it
returns the matched map, the rotated old map, nmatch, est_ok (neither
nan_fail nor fewer than GlobalMatchThreshold matches) and R0.
`md_depth` is `depth_filter.regularize_1_iter` and `depth_ekf` on a
map, then, with `rescale`, `estimate_rescaling_opt`, the apply_res
divide and the est_ok select (the mono and VI tail); without, the
filtered map alone (the stereo tail, whose own blocks and select
follow). Both give the frame's Kp, Kp_gauge, P_Kp and V_out (without
`rescale`: Kp = Kp_gauge = 1 and the previous P_Kp carried).

On CUDA tensors each is one launch of K5 (`md_match_kernel`,
`md_depth_kernel`, built by `nvcc` at first use), through the custom ops
`rebvo_tpu_torch::md_match` and `rebvo_tpu_torch::md_depth`, whose vmap
rules hand every vmapped lane to that one launch; each launch adds one to
the wrapper's `.launches` and to the obs counter `md.match` or
`md.depth`. On CPU tensors the ops run the plain versions (`match_plain`,
`depth_plain`: the package's plain functions, lane by lane under vmap).
There is no fallback from the card to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.core.geometry import (rotate_gradients,
                                           rotate_hom_points, so3_exp)
from rebvo_tpu_torch.frontend.state import BIG, KeylineMap
from rebvo_tpu_torch.kernels import cuda_build
from rebvo_tpu_torch.kernels.depth_filter import (depth_ekf,
                                                  estimate_rescaling_opt,
                                                  regularize_1_iter)
from rebvo_tpu_torch.kernels.matching import (cang_min_of,
                                              directed_matching_field,
                                              forward_match)

Tensor = torch.Tensor

# The maps' fields the kernels read, in the order of their pointer arrays
# (csrc/match_depth.cu: MatchIn, DepthIn), and the rows they write
OLD_FIELDS = ("valid", "px", "py", "rho", "s_rho", "gx", "gy", "n_m", "x",
              "y", "ax", "ay", "arho", "m_num", "m_id_kf")
NEW_FIELDS = ("valid", "px", "py", "gx", "gy", "n_m", "rho", "s_rho", "p0x",
              "p0y", "g0x", "g0y", "n_m0", "ax", "ay", "arho", "m_num",
              "m_id", "m_id_kf")
MATCH_ROWS = ("rho", "s_rho", "p0x", "p0y", "g0x", "g0y", "n_m0", "ax", "ay",
              "arho")
ROTATED_ROWS = ("px", "py", "rho", "s_rho", "gx", "gy")
MATCH_INT_ROWS = ("m_num", "m_id", "m_id_kf")
DEPTH_FIELDS = ("valid", "n_id", "p_id", "gx", "gy", "n_m", "px", "py", "rho",
                "s_rho", "rho0", "s_rho0", "m_id", "m_num", "p0x", "p0y",
                "g0x", "g0y", "n_m0")
DEPTH_ROWS = ("rho", "s_rho", "rho0", "s_rho0")
N_SCALARS = 6                    # Kp, Kp_gauge, P_Kp, V_out [3]
RESCALE_ITERS = 5                # estimate_rescaling_opt's default

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_INT_FIELDS = ("m_num", "m_id", "m_id_kf", "n_id", "p_id")


def _dtype(field: str):
    return _BOOL if field == "valid" else \
        _I32 if field in _INT_FIELDS else _F32


class MatchResult(NamedTuple):
    new: KeylineMap      # the frame's map, forward transferred and matched
    old: KeylineMap      # the old map, forward rotated
    nmatch: Tensor       # int32 directed matches
    est_ok: Tensor       # bool: no nan_fail and nmatch >= the threshold
    R0: Tensor           # [3, 3] the old map's rotation (R = R0.T)


class DepthResult(NamedTuple):
    klm: KeylineMap      # rho, s_rho, rho0, s_rho0 filtered (and selected)
    Kp: Tensor           # 1 without rescale
    Kp_gauge: Tensor
    P_Kp: Tensor
    V_out: Tensor        # [3]


def rotate_map(klm: KeylineMap, R0: Tensor, zfm: float) -> KeylineMap:
    """Forward-rotate an edge map (edge_tracker::rotate_keylines)."""
    px, py, rho, s_rho = rotate_hom_points(R0, klm.px, klm.py, klm.rho,
                                           klm.s_rho, zfm)
    gx, gy = rotate_gradients(R0, klm.gx, klm.gy)
    return klm._replace(px=px, py=py, rho=rho, s_rho=s_rho, gx=gx, gy=gy)


def _partial_map(fields, tensors, **extra) -> KeylineMap:
    """A KeylineMap of the named fields (None elsewhere)."""
    kw = dict.fromkeys(KeylineMap._fields)
    kw.update(zip(fields, tensors), **extra)
    return KeylineMap(**kw)


# ---------------------------------------------------------------------------
# The plain versions (one lane)
# ---------------------------------------------------------------------------


def match_maps(old: KeylineMap, new: KeylineMap, m_id_f, w, r0, back_rot,
               nan_fail, matcher, *, zfm: float, gmt: int):
    """The stage's matching on maps: the forward transfer along m_id_f
    (None: none), the old map's rotation by so3_exp(w) (back rotation its
    transpose) or by r0 (back rotation back_rot), then `matcher(new,
    rotated old, back rotation)`, a directed matcher of kernels/matching.
    Returns (its result, the rotated old map, R0, est_ok)."""
    if m_id_f is not None:
        new, _ = forward_match(old, new, m_id_f)
    if w is not None:
        r0 = so3_exp(w)
        back_rot = r0.T
    rot = rotate_map(old, r0, zfm)
    dres = matcher(new, rot, back_rot)
    est_ok = (~nan_fail) & (~(dres.nmatch < gmt))
    return dres, rot, r0, est_ok


def match_plain(old_t, m_id_f, new_t, field, vel, p_v, w, r0, back_rot,
                nan_fail, *, zfm: float, cx: float, cy: float, width: int,
                height: int, max_steps: int, stride: int, min_thr_mod: float,
                min_thr_ang: float, max_radius: float, loc: float, gmt: int):
    """md_match's plain version on one lane: the old map's OLD_FIELDS,
    m_id_f or None, the new map's NEW_FIELDS, the old match field, Vel,
    P_V, W or (R0, BackRot), nan_fail. Returns the float rows
    [MATCH_ROWS + ROTATED_ROWS, K], the int rows [MATCH_INT_ROWS, K], R0,
    nmatch and est_ok."""
    old = _partial_map(OLD_FIELDS, old_t)
    new = _partial_map(NEW_FIELDS, new_t, x=new_t[NEW_FIELDS.index("px")])

    def matcher(new, rot, back_rot):
        return directed_matching_field(
            new, rot, field, vel, p_v, back_rot, zfm=zfm, cx=cx, cy=cy,
            width=width, height=height, max_steps=max_steps, stride=stride,
            min_thr_mod=min_thr_mod, min_thr_ang=min_thr_ang,
            max_radius=max_radius, loc_uncertainty=loc)
    dres, rot, r0, est_ok = match_maps(old, new, m_id_f, w, r0, back_rot,
                                       nan_fail, matcher, zfm=zfm, gmt=gmt)
    out_f = torch.stack([getattr(dres.new, f) for f in MATCH_ROWS] +
                        [getattr(rot, f) for f in ROTATED_ROWS])
    out_i = torch.stack([getattr(dres.new, f) for f in MATCH_INT_ROWS])
    return (out_f, out_i, r0.clone(memory_format=torch.contiguous_format),
            dres.nmatch, est_ok)


def depth_plain(map_t, vel, nan_fail, nmatch, frame_count, p_kp, *,
                rescale: bool, do_res: bool, imu_boot: bool, brf: int,
                gmt: int, thresh: float, zfm: float, rq: float, loc: float):
    """md_depth's plain version on one lane: the map's DEPTH_FIELDS, Vel,
    nan_fail, nmatch, frame_count and the previous P_Kp. Returns the rows
    [DEPTH_ROWS, K] and the scalars [N_SCALARS]."""
    klm = _partial_map(DEPTH_FIELDS, map_t)
    proc, _ = regularize_1_iter(klm, thresh)
    proc = depth_ekf(proc, vel, zfm, reshape_q_abs=rq, loc_uncertainty=loc)
    one = torch.ones((), dtype=vel.dtype, device=vel.device)
    match_fail = nmatch < gmt
    est_ok = (~nan_fail) & (~match_fail)
    if rescale:
        proc, Kp_new, P_Kp_new = estimate_rescaling_opt(proc, apply=False)
        apply_res = torch.full((), bool(do_res), dtype=torch.bool,
                               device=vel.device)
        if imu_boot:
            boot = frame_count <= brf
            moving = torch.abs(Kp_new - 1.0) > 0.05
            apply_res = apply_res | (boot & moving & est_ok)
        div = torch.where(apply_res, Kp_new, one)
        proc = proc._replace(rho=proc.rho / div, s_rho=proc.s_rho / div)
        rows = torch.stack([torch.where(est_ok, getattr(proc, f),
                                        getattr(klm, f))
                            for f in DEPTH_ROWS])
        Kp = torch.where(est_ok, Kp_new, one)
        Kp_gauge = torch.where(apply_res, one, Kp)
    else:
        # the stereo tail selects after its own blocks; its scale is the
        # pair's
        rows = torch.stack([getattr(proc, f) for f in DEPTH_ROWS])
        Kp = Kp_gauge = one
        P_Kp_new = p_kp
    P_Kp = torch.where(nan_fail, torch.full_like(P_Kp_new, BIG),
                       torch.where(match_fail,
                                   torch.full_like(P_Kp_new, 10.0), P_Kp_new))
    V_out = torch.where(est_ok, vel, torch.zeros_like(vel))
    return rows, torch.cat([Kp[None], Kp_gauge[None], P_Kp[None], V_out])


# ---------------------------------------------------------------------------
# K5's launch paths (csrc/match_depth.cu)
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# md_match_launch: the pointer array and its length; out_f, out_i, out_r,
# nmatch, est_ok; L, K, H, W, max_steps, stride, gmt, card; zfm, inv_zfm,
# cx, cy, thr_mod, cang_min, max_radius, loc, full, l2, half; stream
MATCH_ARGTYPES = [_P, _I] + [_P] * 5 + [_I] * 8 + [_F] * 11 + [_P]
# md_depth_launch: the pointer array and its length; out_f, out_s; L, K,
# rescale, do_res, imu_boot, brf, gmt, iters, card; thresh, one_m_thresh,
# inv_one_m_thresh, zfm, rq2, l2; stream
DEPTH_ARGTYPES = [_P, _I] + [_P] * 2 + [_I] * 9 + [_F] * 6 + [_P]


def _check(who: str, named, lanes: tuple, dev) -> list:
    """Each (name, tensor, dtype, trailing shape) checked; the pointers
    (0 for an absent optional input)."""
    ptrs = []
    for name, t, dtype, tail in named:
        if t is None:
            ptrs.append(0)
            continue
        if not isinstance(t, Tensor) or t.dtype != dtype:
            raise TypeError(f"{who}: {name} must be a {dtype} tensor")
        if t.device != dev:
            raise ValueError(f"{who}: {name} is on {t.device}, the map on "
                             f"{dev}")
        if tuple(t.shape) != lanes + tuple(tail):
            raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                             f"expected {lanes + tuple(tail)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        ptrs.append(t.data_ptr())
    return ptrs


def _lanes_and_K(who: str, ref: Tensor, lead: Tensor):
    """The lane axes (those of `lead`, a per-lane [..., 3] tensor) and K,
    the trailing size of `ref`, a map field."""
    if not isinstance(lead, Tensor) or lead.ndim < 1:
        raise TypeError(f"{who}: Vel must be a [..., 3] tensor")
    lanes = tuple(lead.shape[:-1])
    if not isinstance(ref, Tensor) or ref.ndim != len(lanes) + 1:
        raise ValueError(f"{who}: the map's valid must be [..., K] with "
                         f"Vel's lanes {lanes}")
    K = ref.shape[-1]
    if K < 1 or math.prod(lanes) < 1:
        raise ValueError(f"{who}: needs K >= 1 slots and a lane, got K={K}, "
                         f"lanes {lanes}")
    return lanes, K


def match_launch(launch: Callable[..., int], old_t, m_id_f, new_t, field,
                 vel, p_v, w, r0, back_rot, nan_fail, stream, *, zfm: float,
                 cx: float, cy: float, width: int, height: int,
                 max_steps: int, stride: int, min_thr_mod: float,
                 min_thr_ang: float, max_radius: float, loc: float,
                 gmt: int):
    """md_match through its C entry point `launch` (MATCH_ARGTYPES) on
    the inputs of `match_plain`, each with the same leading lane axes
    (none for one lane), contiguous. Returns the float rows [16, ..., K],
    the int rows [3, ..., K] (field-major), R0 [..., 3, 3], nmatch and
    est_ok [...]; raises on an input the kernel does not take, or if the
    launcher refuses. The wrapper passes the card's entry point; the tests
    a host build of the same source. Inputs on a CUDA device are rounded
    as PyTorch rounds on the card, others as on the CPU."""
    who = "md_match"
    if len(old_t) != len(OLD_FIELDS) or len(new_t) != len(NEW_FIELDS):
        raise ValueError(f"{who}: takes {len(OLD_FIELDS)} old and "
                         f"{len(NEW_FIELDS)} new fields, got {len(old_t)} "
                         f"and {len(new_t)}")
    if (w is None) == (r0 is None) or (r0 is None) != (back_rot is None):
        raise ValueError(f"{who}: takes W, or R0 and BackRot")
    lanes, K = _lanes_and_K(who, old_t[0], vel)
    dev = vel.device
    named = ([(f"old.{f}", t, _dtype(f), (K,))
              for f, t in zip(OLD_FIELDS, old_t)] +
             [("m_id_f", m_id_f, _I32, (K,))] +
             [(f"new.{f}", t, _dtype(f), (K,))
              for f, t in zip(NEW_FIELDS, new_t)] +
             [("field", field, _I32, (height, width)),
              ("Vel", vel, _F32, (3,)), ("P_V", p_v, _F32, (3, 3)),
              ("W", w, _F32, (3,)), ("R0", r0, _F32, (3, 3)),
              ("BackRot", back_rot, _F32, (3, 3)),
              ("nan_fail", nan_fail, _BOOL, ())])
    ptrs = _check(who, named, lanes, dev)
    L = math.prod(lanes)
    out_f = torch.empty((len(MATCH_ROWS) + len(ROTATED_ROWS),) + lanes + (K,),
                        dtype=_F32, device=dev)
    out_i = torch.empty((len(MATCH_INT_ROWS),) + lanes + (K,), dtype=_I32,
                        device=dev)
    out_r = torch.empty(lanes + (3, 3), dtype=_F32, device=dev)
    nmatch = torch.empty(lanes, dtype=_I32, device=dev)
    est_ok = torch.empty(lanes, dtype=_BOOL, device=dev)
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    err = launch(arr, len(ptrs), out_f.data_ptr(), out_i.data_ptr(),
                 out_r.data_ptr(), nmatch.data_ptr(), est_ok.data_ptr(), L,
                 K, height, width, max_steps, stride, gmt,
                 int(dev.type == "cuda"), zfm,
                 float(np.float32(1.0) / np.float32(zfm)), cx, cy,
                 min_thr_mod, cang_min_of(min_thr_ang), max_radius, loc,
                 max_radius + loc, loc * loc, 0.5 * stride, stream)
    if err != 0:
        raise RuntimeError(f"md_match kernel launch failed: cudaError {err}")
    return out_f, out_i, out_r, nmatch, est_ok


def depth_launch(launch: Callable[..., int], map_t, vel, nan_fail, nmatch,
                 frame_count, p_kp, stream, *, rescale: bool, do_res: bool,
                 imu_boot: bool, brf: int, gmt: int, thresh: float,
                 zfm: float, rq: float, loc: float):
    """md_depth through its C entry point `launch` (DEPTH_ARGTYPES) on the
    inputs of `depth_plain`, as match_launch. Returns the rows [4, ..., K]
    (field-major) and the scalars [..., N_SCALARS]."""
    who = "md_depth"
    if len(map_t) != len(DEPTH_FIELDS):
        raise ValueError(f"{who}: takes {len(DEPTH_FIELDS)} map fields, got "
                         f"{len(map_t)}")
    lanes, K = _lanes_and_K(who, map_t[0], vel)
    dev = vel.device
    named = ([(f, t, _dtype(f), (K,)) for f, t in zip(DEPTH_FIELDS, map_t)] +
             [("Vel", vel, _F32, (3,)), ("nan_fail", nan_fail, _BOOL, ()),
              ("nmatch", nmatch, _I32, ()),
              ("frame_count", frame_count, _I32, ()),
              ("P_Kp", p_kp, _F32, ())])
    ptrs = _check(who, named, lanes, dev)
    L = math.prod(lanes)
    out_f = torch.empty((len(DEPTH_ROWS),) + lanes + (K,), dtype=_F32,
                        device=dev)
    out_s = torch.empty(lanes + (N_SCALARS,), dtype=_F32, device=dev)
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    one_m = 1.0 - thresh
    err = launch(arr, len(ptrs), out_f.data_ptr(), out_s.data_ptr(), L, K,
                 int(rescale), int(do_res), int(imu_boot), brf, gmt,
                 RESCALE_ITERS, int(dev.type == "cuda"), thresh, one_m,
                 float(np.float32(1.0) / np.float32(one_m)), zfm, rq * rq,
                 loc * loc, stream)
    if err != 0:
        raise RuntimeError(f"md_depth kernel launch failed: cudaError {err}")
    return out_f, out_s


@functools.cache
def _launchers():
    """K5's two C entry points, built and loaded at first use."""
    lib = cuda_build.library("match_depth")
    lib.md_match_launch.argtypes = MATCH_ARGTYPES
    lib.md_depth_launch.argtypes = DEPTH_ARGTYPES
    for fn in (lib.md_match_launch, lib.md_depth_launch):
        fn.restype = ctypes.c_int
    return lib.md_match_launch, lib.md_depth_launch


def _stream(t: Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _per_lane(fn, lanes, args, stack_dims):
    """`fn` lane by lane over the leading `lanes` of every tensor in
    `args` (lists of tensors too; None passes), each output stacked on
    its dim of `stack_dims`."""
    n = math.prod(lanes)

    def lane(x, i):
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return [lane(y, i) for y in x]
        return x.reshape((n,) + x.shape[len(lanes):])[i]

    outs = [fn(*[lane(a, i) for a in args]) for i in range(n)]
    res = []
    for d, o in zip(stack_dims, zip(*outs)):
        st = torch.stack(o, dim=d)
        res.append(st.reshape(st.shape[:d] + lanes + st.shape[d + 1:]))
    return tuple(res)


@torch.library.custom_op("rebvo_tpu_torch::md_match", mutates_args=())
def _match_op(old: List[Tensor], m_id_f: Optional[Tensor], new: List[Tensor],
              field: Tensor, vel: Tensor, p_v: Tensor, w: Optional[Tensor],
              r0: Optional[Tensor], back_rot: Optional[Tensor],
              nan_fail: Tensor, zfm: float, cx: float, cy: float, width: int,
              height: int, max_steps: int, stride: int, min_thr_mod: float,
              min_thr_ang: float, max_radius: float, loc: float, gmt: int
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """md_match on the CUDA device, its plain version on the CPU; the
    lanes are the leading axes of `vel`."""
    kw = dict(zfm=zfm, cx=cx, cy=cy, width=width, height=height,
              max_steps=max_steps, stride=stride, min_thr_mod=min_thr_mod,
              min_thr_ang=min_thr_ang, max_radius=max_radius, loc=loc,
              gmt=gmt)
    args = (old, m_id_f, new, field, vel, p_v, w, r0, back_rot, nan_fail)
    if vel.device.type == "cpu":
        lanes = tuple(vel.shape[:-1])
        plain = functools.partial(match_plain, **kw)
        if not lanes:
            return plain(*args)
        return _per_lane(plain, lanes, args, (1, 1, 0, 0, 0))
    if vel.device.type != "cuda":
        raise ValueError(f"md_match: unsupported device {vel.device}")
    out = match_launch(_launchers()[0], *args, _stream(vel), **kw)
    md_match.launches += 1
    obs.count("md.match")
    return out


@_match_op.register_fake
def _match_fake(old, m_id_f, new, field, vel, *rest):
    lanes = tuple(vel.shape[:-1])
    K = old[0].shape[-1]
    nf = len(MATCH_ROWS) + len(ROTATED_ROWS)
    return (vel.new_empty((nf,) + lanes + (K,)),
            vel.new_empty((len(MATCH_INT_ROWS),) + lanes + (K,),
                          dtype=_I32),
            vel.new_empty(lanes + (3, 3)), vel.new_empty(lanes, dtype=_I32),
            vel.new_empty(lanes, dtype=_BOOL))


def _batched(x, d, B):
    """An input of a vmap rule with its lanes first, contiguous (an
    unbatched one expanded to the B lanes)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [_batched(y, dd, B) for y, dd in
                zip(x, d if isinstance(d, (list, tuple)) else [d] * len(x))]
    t = x.movedim(d, 0) if d is not None else x.expand((B,) + x.shape)
    return t.contiguous()


def _match_vmap(info, in_dims, *args):
    """vmap rule of md_match: every lane in one call (one launch on the
    card); the float and int rows come back lanes second."""
    B = info.batch_size
    ts = [_batched(a, d, B) for a, d in zip(args[:10], in_dims[:10])]
    return _match_op(*ts, *args[10:]), (1, 1, 0, 0, 0)


torch.library.register_vmap("rebvo_tpu_torch::md_match", _match_vmap)


@torch.library.custom_op("rebvo_tpu_torch::md_depth", mutates_args=())
def _depth_op(klm: List[Tensor], vel: Tensor, nan_fail: Tensor,
              nmatch: Tensor, frame_count: Tensor, p_kp: Tensor, rescale: bool,
              do_res: bool, imu_boot: bool, brf: int, gmt: int,
              thresh: float, zfm: float, rq: float, loc: float
              ) -> Tuple[Tensor, Tensor]:
    """md_depth on the CUDA device, its plain version on the CPU."""
    kw = dict(rescale=rescale, do_res=do_res, imu_boot=imu_boot, brf=brf,
              gmt=gmt, thresh=thresh, zfm=zfm, rq=rq, loc=loc)
    args = (klm, vel, nan_fail, nmatch, frame_count, p_kp)
    if vel.device.type == "cpu":
        lanes = tuple(vel.shape[:-1])
        plain = functools.partial(depth_plain, **kw)
        if not lanes:
            return plain(*args)
        return _per_lane(plain, lanes, args, (1, 0))
    if vel.device.type != "cuda":
        raise ValueError(f"md_depth: unsupported device {vel.device}")
    out = depth_launch(_launchers()[1], *args, _stream(vel), **kw)
    md_depth.launches += 1
    obs.count("md.depth")
    return out


@_depth_op.register_fake
def _depth_fake(klm, vel, *rest):
    lanes = tuple(vel.shape[:-1])
    K = klm[0].shape[-1]
    return (vel.new_empty((len(DEPTH_ROWS),) + lanes + (K,)),
            vel.new_empty(lanes + (N_SCALARS,)))


def _depth_vmap(info, in_dims, *args):
    """vmap rule of md_depth: every lane in one call; the rows come back
    lanes second."""
    B = info.batch_size
    ts = [_batched(a, d, B) for a, d in zip(args[:6], in_dims[:6])]
    return _depth_op(*ts, *args[6:]), (1, 0)


torch.library.register_vmap("rebvo_tpu_torch::md_depth", _depth_vmap)


# ---------------------------------------------------------------------------
# The wrappers the step calls
# ---------------------------------------------------------------------------


def match_args(old: KeylineMap, new: KeylineMap, field_img: Tensor,
               V: Tensor, P_V: Tensor, nan_fail: Tensor, *, cam, params,
               m_id_f: Optional[Tensor] = None, W: Optional[Tensor] = None,
               R0: Optional[Tensor] = None, R: Optional[Tensor] = None):
    """md_match's op inputs: the tensors (match_plain's positional
    arguments) and the keywords."""
    p = params
    stride = int(p.MatchFieldStride)
    ts = ([getattr(old, f) for f in OLD_FIELDS], m_id_f,
          [getattr(new, f) for f in NEW_FIELDS], field_img, V, P_V, W, R0, R,
          nan_fail)
    kw = dict(zfm=float(cam.zfm), cx=float(cam.cx), cy=float(cam.cy),
              width=int(cam.width), height=int(cam.height),
              max_steps=int(p.SearchRange / stride) + 3, stride=stride,
              min_thr_mod=float(p.MatchThreshModule),
              min_thr_ang=float(p.MatchThreshAngle),
              max_radius=float(p.SearchRange),
              loc=float(p.LocationUncertaintyMatch),
              gmt=int(p.GlobalMatchThreshold))
    return ts, kw


def md_match(old: KeylineMap, new: KeylineMap, field_img: Tensor, V: Tensor,
             P_V: Tensor, nan_fail: Tensor, *, cam, params,
             m_id_f: Optional[Tensor] = None, W: Optional[Tensor] = None,
             R0: Optional[Tensor] = None, R: Optional[Tensor] = None
             ) -> MatchResult:
    """The forward transfer (given `m_id_f`), the old map's forward
    rotation (by so3_exp(W), or by R0 with the back rotation R) and the
    strided field matching (MatchFieldStride > 0) of one frame: on CUDA
    tensors one launch of md_match, on CPU tensors its plain version."""
    ts, kw = match_args(old, new, field_img, V, P_V, nan_fail, cam=cam,
                        params=params, m_id_f=m_id_f, W=W, R0=R0, R=R)
    out_f, out_i, r0, nmatch, est_ok = _match_op(*ts, **kw)
    f = out_f.unbind(0)
    n = len(MATCH_ROWS)
    new = new._replace(**dict(zip(MATCH_ROWS, f[:n])),
                       **dict(zip(MATCH_INT_ROWS, out_i.unbind(0))))
    old = old._replace(**dict(zip(ROTATED_ROWS, f[n:])))
    return MatchResult(new, old, nmatch, est_ok, r0)


md_match.launches = 0


def depth_args(klm: KeylineMap, V: Tensor, nan_fail: Tensor,
               nmatch: Tensor, frame_count: Tensor, P_Kp: Tensor, *, cam,
               params, rescale: bool):
    """md_depth's op inputs: the tensors (depth_plain's positional
    arguments) and the keywords."""
    p = params
    ts = ([getattr(klm, f) for f in DEPTH_FIELDS], V, nan_fail, nmatch,
          frame_count, P_Kp)
    kw = dict(rescale=bool(rescale), do_res=bool(p.DoReScaling),
              imu_boot=bool(p.ImuMode > 0 and p.BootstrapRescaleFrames > 0),
              brf=int(p.BootstrapRescaleFrames),
              gmt=int(p.GlobalMatchThreshold),
              thresh=float(p.RegularizeThresh), zfm=float(cam.zfm),
              rq=float(p.ReshapeQAbsolute), loc=float(p.LocationUncertainty))
    return ts, kw


def md_depth(klm: KeylineMap, V: Tensor, nan_fail: Tensor, nmatch: Tensor,
             frame_count: Tensor, P_Kp: Tensor, *, cam, params,
             rescale: bool) -> DepthResult:
    """regularize_1_iter and depth_ekf of the matched map, then, with
    `rescale`, the rescaling and the est_ok select; the tail's scalars
    (P_Kp: the previous frame's): on CUDA tensors one launch of
    md_depth, on CPU tensors its plain version."""
    ts, kw = depth_args(klm, V, nan_fail, nmatch, frame_count, P_Kp,
                        cam=cam, params=params, rescale=rescale)
    rows, s = _depth_op(*ts, **kw)
    klm = klm._replace(**dict(zip(DEPTH_ROWS, rows.unbind(0))))
    return DepthResult(klm, s[..., 0], s[..., 1], s[..., 2], s[..., 3:6])


md_depth.launches = 0
