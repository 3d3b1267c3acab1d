"""K3, the pose solver kernel (`csrc/pose_lm.cu`), run on the CPU.

`tests/tile_host.py` builds the kernel's own source with g++ under the
host emulation of the CUDA subset it uses (`tests/cuda_host_emu.h`: a
thread-block cluster's threads as std::threads, its barrier, each other's
shared memory, the warp's shuffle-tree sum) and launches it through the
card's launch path (`pose_solver.pose_launch`). The inputs are the
`minimizer_rv` calls of the port's own mono step on the SMALL fixture of
test_torch_step.py (376x240, K=8192), recorded on the CPU.

Against the plain version (`minimizer_rv_plain`), for init_type 0, 1 and 2,
with and without a vote mask: m_id_f equal, and the float32 bits of Vel,
W0 and score. W_X, RVel, RW0 and rel_error_score within one float32 ulp:
J^T J is a float64 sum in another order and the inverse an LU in another
order than LAPACK's, so a value that lies near a float32 rounding boundary
can round the other way. rel_error = |h| / (|X| + 1e-30) within two: each
norm is a sum of squares in another order than PyTorch's (one ulp each).

The plain version runs with an IEEE square root: on the CPU `torch.sqrt`
of float32 is not correctly rounded (about 0.6% of values differ from the
IEEE root in the last bit), while the card's, like the kernel's, is; the
noise shaping q = sqrt(s^2 + 1) would otherwise differ in a few slots.
"""

import numpy as np
import pytest
import torch

from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.frontend import step as step_mod
from rebvo_tpu_torch.frontend.step import VOFrontend
from rebvo_tpu_torch.io.render import render_plane_seq
from rebvo_tpu_torch.kernels import pose_solver as ps

import tile_host

pytestmark = pytest.mark.skipif(
    tile_host.compiler() is None,
    reason="the host build of the CUDA kernels needs g++")

torch.set_num_threads(2)

SMALL = dict(width=376, height=240, zf=200.0, cx=188.0, cy=120.0, z0=3.0)
N_STEPS = 3
CFG = ("zfm", "cx", "cy", "width", "height", "match_thresh", "k_huber",
       "iter_max", "init_iter", "init_type")
EXACT = {"Vel": slice(0, 3), "W0": slice(3, 6), "score": slice(60, 61)}
ULPS = {"RVel": (slice(6, 15), 1), "RW0": (slice(15, 24), 1),
        "W_X": (slice(24, 60), 1), "rel_error": (slice(61, 62), 2),
        "rel_error_score": (slice(62, 63), 1)}


@pytest.fixture(scope="module")
def calls():
    """The port's minimizer_rv calls of N_STEPS mono steps on the CPU:
    [(inputs in pose_solver._INPUTS' order, config)]."""
    p = REBVOParameters().replace(
        ImageWidth=SMALL["width"], ImageHeight=SMALL["height"],
        ZfX=SMALL["zf"], ZfY=SMALL["zf"], PPx=SMALL["cx"], PPy=SMALL["cy"],
        KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0, KeylineMax=8192,
        MaxPoints=8192, ReferencePoints=3000, TrackPoints=8192,
        GlobalMatchThreshold=200, DetectorThresh=0.03,
        DetectorAutoGain=1e-6)
    pos = np.zeros((N_STEPS + 1, 3))
    pos[:, 0] = np.arange(N_STEPS + 1) * 0.02
    frames = render_plane_seq(N_STEPS + 1, cam_positions=pos,
                              plane_normal=(0.35, 0.25, 1.0), **SMALL)
    seen = []

    def record(Vel, W0, old, fv, **kw):
        seen.append(((Vel, W0, old.valid, old.px, old.py, old.rho,
                      old.s_rho, old.m_num, old.gx, old.gy, old.n_m, fv.ikl,
                      fv.attrs, kw["max_s_rho"].float(),
                      kw["match_num_min"].int(), kw["vote_mask"]),
                     {k: kw[k] for k in CFG}))
        return ps.minimizer_rv(Vel, W0, old, fv, **kw)

    fe = VOFrontend(p, device="cpu")
    st = fe.bootstrap(fe.init(), frames[0], 0.0)
    step_mod.minimizer_rv, orig = record, step_mod.minimizer_rv
    try:
        for i in range(1, N_STEPS + 1):
            st, _ = fe.step(st, frames[i], i / 20.0)
    finally:
        step_mod.minimizer_rv = orig
    assert len(seen) == N_STEPS
    return seen


def _ieee_sqrt(sqrt):
    def f(x, *a, **kw):
        if x.dtype == torch.float32:
            return sqrt(x.double()).float()
        return sqrt(x, *a, **kw)
    return f


def _plain(monkeypatch, tensors, cfg):
    """The plain version, packed, with the card's (IEEE) float32 root."""
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _ieee_sqrt(torch.sqrt))
        return ps._plain(tensors, **cfg)


def _ulps(a, b):
    """Distance in float32 steps, elementwise (NaNs equal to NaNs)."""
    def ordered(x):
        i = x.view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(a) - ordered(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), 0, d)


def _vote_mask(valid, seed):
    rng = np.random.default_rng(seed)
    return valid & torch.from_numpy(rng.random(valid.shape[-1]) < 0.7)


@pytest.mark.parametrize("init_type", [0, 1, 2])
@pytest.mark.parametrize("vote", [False, True], ids=["all", "vote_mask"])
def test_kernel_matches_plain(calls, monkeypatch, init_type, vote):
    for n, (tensors, cfg) in enumerate(calls):
        if vote:
            tensors = tensors[:15] + (_vote_mask(tensors[2], n),)
        cfg = dict(cfg, init_type=init_type)
        out, mid = tile_host.pose(tensors, **cfg)
        ref, ref_mid = _plain(monkeypatch, tensors, cfg)
        assert torch.equal(mid, ref_mid), n
        assert int((mid >= 0).sum()) > 500, n
        for name, sl in EXACT.items():
            assert torch.equal(out[sl].view(torch.int32),
                               ref[sl].view(torch.int32)), (n, name)
        for name, (sl, tol) in ULPS.items():
            assert int(_ulps(out[sl], ref[sl]).max()) <= tol, (n, name)
        assert bool(torch.isfinite(out).all()), n


def test_empty_map(calls, monkeypatch):
    """No valid keyline: every step is singular. Both versions keep the
    start (the LM rejects every non-finite step), and the inverse of the
    zero J^T J is non-finite in both."""
    tensors, cfg = calls[-1]
    tensors = list(tensors)
    tensors[2] = torch.zeros_like(tensors[2])
    for init_type in (1, 2):
        c = dict(cfg, init_type=init_type)
        out, mid = tile_host.pose(tensors, **c)
        ref, ref_mid = _plain(monkeypatch, tensors, c)
        assert bool((mid == -1).all()) and torch.equal(mid, ref_mid)
        assert torch.equal(out[0:6], ref[0:6])
        assert float(out[60]) == float(ref[60]) == 0.0
        for sl in (ULPS["RVel"][0], ULPS["RW0"][0]):
            assert not bool(torch.isfinite(out[sl]).any())
            assert not bool(torch.isfinite(ref[sl]).any())


def _stacked(calls):
    return [None if ts[0] is None else torch.stack(ts)
            for ts in zip(*(c[0] for c in calls))]


def test_lanes_in_one_launch(calls):
    """Three lanes (the three steps' inputs) in one launch: each lane's
    outputs equal the lane launched alone."""
    cfg = calls[0][1]
    out, mid = tile_host.pose(_stacked(calls), **cfg)
    assert out.shape == (N_STEPS, ps.N_OUT)
    for n, (tensors, _) in enumerate(calls):
        o1, m1 = tile_host.pose(tensors, **cfg)
        assert torch.equal(out[n].view(torch.int32), o1.view(torch.int32))
        assert torch.equal(mid[n], m1)


def test_vmap_rule_hands_lanes_to_one_call(calls):
    """vmap of minimizer_rv goes through the op's vmap rule (one call
    over the lanes; on the CPU the plain version lane by lane) and equals
    the lanes one at a time, an unbatched max_s_rho expanded."""
    cfg = dict(calls[0][1])
    cfg.pop("init_type")
    Vel, W0, *fields = _stacked(calls)[:11]
    ikl, attrs, _, mnm = _stacked(calls)[11:15]
    msr = calls[0][0][13]

    def solve(v, w, f, ik, at, n):
        return tuple(ps.minimizer_rv(
            v, w, ps.SolverMap(*f), ps.FieldView(ik, at), max_s_rho=msr,
            match_num_min=n, **cfg))

    before = ps.minimizer_rv.launches
    got = torch.func.vmap(solve)(Vel, W0, fields, ikl, attrs, mnm)
    assert ps.minimizer_rv.launches == before      # the CPU launches none
    for n in range(N_STEPS):
        one = solve(Vel[n], W0[n], [f[n] for f in fields], ikl[n],
                    attrs[n], mnm[n])
        for a, b in zip(got, one):
            assert torch.equal(a[n], b)


def test_launch_refusals(calls):
    tensors, cfg = calls[0]
    bad = list(tensors)
    bad[0] = tensors[0].double()
    with pytest.raises(TypeError, match="Vel"):
        tile_host.pose(bad, **cfg)
    bad = list(tensors)
    bad[12] = tensors[12][:, :6]
    with pytest.raises(ValueError, match="attrs"):
        tile_host.pose(bad, **cfg)
    with pytest.raises(RuntimeError, match="launch failed"):
        tile_host.pose(tensors, **dict(cfg, iter_max=-1))
