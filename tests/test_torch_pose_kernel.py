"""K3, the pose solver kernel (`csrc/pose_lm.cu`), in both its modes,
run on the CPU.

`tests/tile_host.py` builds the kernel's own source with g++ under the
host emulation of the CUDA subset it uses (`tests/cuda_host_emu.h`: a
thread-block cluster's threads as std::threads, its barrier, each other's
shared memory, the warp's shuffle-tree sum) and launches it through the
card's launch path (`pose_solver.pose_launch`). The inputs are recorded
on the CPU at the SMALL size of test_torch_step.py (376x240, K=8192): the
`minimizer_rv` calls of the port's own mono step (the 6-dof mode), and
the `minimizer_v` calls of its visual-inertial step on a
`write_euroc_vi` directory, the camera still and then moving, the scale
filter running in the last (the 3-dof mode, as test_torch_vi_scan.py's
fixture with the IMU mounted as the camera).

Against the plain versions. 6-dof (`minimizer_rv_plain`), for init_type
0, 1 and 2: m_id_f equal, and the float32 bits of Vel, W0 and score.
W_X, RVel, RW0 and rel_error_score within one float32 ulp: J^T J is a
float64 sum in another order and the inverse an LU in another order than
LAPACK's, so a value that lies near a float32 rounding boundary can round
the other way. rel_error = |h| / (|X| + 1e-30) within two: each norm is a
sum of squares in another order than PyTorch's (one ulp each). 3-dof
(`minimizer_v_plain`), for min_mod 0, the step's own and one that gates
half the valid slots: m_id_f equal, the float32 bits of Vel and score,
RVel within one ulp. Both with and without a vote mask.

The plain versions run with an IEEE square root: on the CPU `torch.sqrt`
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
from rebvo_tpu_torch.io.dataset import DatasetSequence, imu_window_size
from rebvo_tpu_torch.io.render import render_plane_seq, write_euroc_vi
from rebvo_tpu_torch.kernels import pose_solver as ps

import tile_host

pytestmark = pytest.mark.skipif(
    tile_host.compiler() is None,
    reason="the host build of the CUDA kernels needs g++")

torch.set_num_threads(2)

SMALL = dict(width=376, height=240, zf=200.0, cx=188.0, cy=120.0, z0=3.0)
SMALL_P = dict(ImageWidth=SMALL["width"], ImageHeight=SMALL["height"],
               ZfX=SMALL["zf"], ZfY=SMALL["zf"], PPx=SMALL["cx"],
               PPy=SMALL["cy"], KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0,
               KeylineMax=8192, MaxPoints=8192, ReferencePoints=3000,
               TrackPoints=8192, GlobalMatchThreshold=200,
               DetectorThresh=0.03, DetectorAutoGain=1e-6)
N_STEPS = 3
# the VI steps: the camera holds still for InitBiasFrameNum + 2 frames,
# the scale filter runs from frame_count 9; the calls compared: a still
# frame, the first moving ones, one with the filter running
N_VI_STEPS = 10
VI_CALLS = (3, 6, 7, 9)
CFG = ("zfm", "cx", "cy", "width", "height", "match_thresh", "k_huber",
       "iter_max", "init_iter", "init_type")
CFG_V = CFG[:-2]
EXACT = {"Vel": slice(0, 3), "W0": slice(3, 6), "score": slice(60, 61)}
ULPS = {"RVel": (slice(6, 15), 1), "RW0": (slice(15, 24), 1),
        "W_X": (slice(24, 60), 1), "rel_error": (slice(61, 62), 2),
        "rel_error_score": (slice(62, 63), 1)}
EXACT_V = {"Vel": slice(0, 3), "score": slice(12, 13)}
ULPS_V = {"RVel": (slice(3, 12), 1)}
VOTE = 15       # the vote mask's and min_mod's places in _INPUTS
MIN_MOD = 16


@pytest.fixture(scope="module")
def calls():
    """The port's minimizer_rv calls of N_STEPS mono steps on the CPU:
    [(inputs in pose_solver._INPUTS' order, config)]."""
    p = REBVOParameters().replace(**SMALL_P)
    pos = np.zeros((N_STEPS + 1, 3))
    pos[:, 0] = np.arange(N_STEPS + 1) * 0.02
    frames = render_plane_seq(N_STEPS + 1, cam_positions=pos,
                              plane_normal=(0.35, 0.25, 1.0), **SMALL)
    seen = []

    def record(Vel, W0, old, fv, **kw):
        seen.append(((Vel, W0, old.valid, old.px, old.py, old.rho,
                      old.s_rho, old.m_num, old.gx, old.gy, old.n_m, fv.ikl,
                      fv.attrs, kw["max_s_rho"].float(),
                      kw["match_num_min"].int(), kw["vote_mask"], None),
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


@pytest.fixture(scope="module")
def calls_v(tmp_path_factory):
    """The port's minimizer_v calls of N_VI_STEPS visual-inertial steps on
    the CPU (those of VI_CALLS): [(inputs in _INPUTS' order, config)]."""
    mav = str(tmp_path_factory.mktemp("pose_v") / "mav0")
    p = REBVOParameters().replace(**SMALL_P, useUndistort=0, ImuMode=2,
                                  InitBiasFrameNum=4, SampleTime=0.005)
    write_euroc_vi(p, N_VI_STEPS + 1, mav, workers=4)
    items = list(DatasetSequence.euroc(mav, window_size=imu_window_size(p)))
    seen = []

    def record(Vel, old, fv, **kw):
        seen.append(((Vel, None, old.valid, old.px, old.py, old.rho,
                      old.s_rho, old.m_num, old.gx, old.gy, old.n_m, fv.ikl,
                      fv.attrs, kw["max_s_rho"].float(),
                      kw["match_num_min"].int(), kw["vote_mask"],
                      kw["min_mod"].float()),
                     dict({k: kw[k] for k in CFG_V},
                          init_iter=ps.V_LADDER_ITERS, init_type=2)))
        return ps.minimizer_v(Vel, old, fv, **kw)

    fe = VOFrontend(p, device="cpu")
    t0, f0, _ = items[0]
    st = fe.bootstrap(fe.init(), torch.as_tensor(f0), t0)
    step_mod.minimizer_v, orig = record, step_mod.minimizer_v
    try:
        for t, f, w in items[1:]:
            st, _ = fe.step_imu(st, torch.as_tensor(f), t, w)
    finally:
        step_mod.minimizer_v = orig
    assert len(seen) == N_VI_STEPS
    return [seen[i] for i in VI_CALLS]


def _calls(request, dof):
    return request.getfixturevalue("calls" if dof == 6 else "calls_v")


def _ieee_sqrt(sqrt):
    def f(x, *a, **kw):
        if x.dtype == torch.float32:
            return sqrt(x.double()).float()
        return sqrt(x, *a, **kw)
    return f


def _plain(monkeypatch, tensors, cfg, dof=6):
    """The plain version, packed, with the card's (IEEE) float32 root."""
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _ieee_sqrt(torch.sqrt))
        return ps._plain(tensors, dof, **cfg)


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


def _with(tensors, i, t):
    return tuple(tensors[:i]) + (t,) + tuple(tensors[i + 1:])


def _min_mod(tensors, which):
    """min_mod of a 3-dof case: 0 (gates nothing), the step's own, or the
    median n_m of the valid slots (gates about half of them)."""
    if which == "zero":
        return torch.zeros(())
    if which == "step":
        return tensors[MIN_MOD]
    valid, n_m = tensors[2], tensors[10]
    return n_m[valid].median().reshape(())


# (dof, init_type or min_mod); the 6-dof cases keep their ids
CASES = [(6, 0), (6, 1), (6, 2), (3, "zero"), (3, "step"), (3, "median")]


@pytest.mark.parametrize("case", CASES, ids=["0", "1", "2", "v-min_mod0",
                                             "v-min_mod_step",
                                             "v-min_mod_median"])
@pytest.mark.parametrize("vote", [False, True], ids=["all", "vote_mask"])
def test_kernel_matches_plain(request, monkeypatch, case, vote):
    dof, arg = case
    exact, ulps = (EXACT, ULPS) if dof == 6 else (EXACT_V, ULPS_V)
    for n, (tensors, cfg) in enumerate(_calls(request, dof)):
        if vote:
            tensors = _with(tensors, VOTE, _vote_mask(tensors[2], n))
        if dof == 6:
            cfg = dict(cfg, init_type=arg)
        else:
            tensors = _with(tensors, MIN_MOD, _min_mod(tensors, arg))
            gated = tensors[2] & (tensors[10] < tensors[MIN_MOD])
            assert (int(gated.sum()) > 1000) == (arg == "median"), n
        out, mid = tile_host.pose(tensors, dof, **cfg)
        ref, ref_mid = _plain(monkeypatch, tensors, cfg, dof)
        assert torch.equal(mid, ref_mid), n
        assert int((mid >= 0).sum()) > 500, n
        for name, sl in exact.items():
            assert torch.equal(out[sl].view(torch.int32),
                               ref[sl].view(torch.int32)), (n, name)
        for name, (sl, tol) in ulps.items():
            assert int(_ulps(out[sl], ref[sl]).max()) <= tol, (n, name)
        assert bool(torch.isfinite(out).all()), n


@pytest.mark.parametrize("dof", [6, 3], ids=["rv", "v"])
def test_empty_map(request, monkeypatch, dof):
    """No valid keyline: every step is singular. Both versions keep the
    start (the LM rejects every non-finite step), and the inverse of the
    zero J^T J is non-finite in both."""
    tensors, cfg = _calls(request, dof)[-1]
    tensors = _with(tensors, 2, torch.zeros_like(tensors[2]))
    n_x, i_score, inverses = ((6, 60, (ULPS["RVel"][0], ULPS["RW0"][0]))
                              if dof == 6 else (3, 12, (ULPS_V["RVel"][0],)))
    for init_type in ((1, 2) if dof == 6 else (2,)):
        c = dict(cfg, init_type=init_type)
        out, mid = tile_host.pose(tensors, dof, **c)
        ref, ref_mid = _plain(monkeypatch, tensors, c, dof)
        assert bool((mid == -1).all()) and torch.equal(mid, ref_mid)
        assert torch.equal(out[0:n_x], ref[0:n_x])
        assert float(out[i_score]) == float(ref[i_score]) == 0.0
        for sl in inverses:
            assert not bool(torch.isfinite(out[sl]).any())
            assert not bool(torch.isfinite(ref[sl]).any())


def _stacked(calls):
    return [None if ts[0] is None else torch.stack(ts)
            for ts in zip(*(c[0] for c in calls))]


@pytest.mark.parametrize("dof", [6, 3], ids=["rv", "v"])
def test_lanes_in_one_launch(request, dof):
    """The recorded calls as lanes of one launch: each lane's outputs
    equal the lane launched alone."""
    calls = _calls(request, dof)
    cfg = calls[0][1]
    out, mid = tile_host.pose(_stacked(calls), dof, **cfg)
    assert out.shape == (len(calls), ps._N_OUT[dof])
    for n, (tensors, _) in enumerate(calls):
        o1, m1 = tile_host.pose(tensors, dof, **cfg)
        assert torch.equal(out[n].view(torch.int32), o1.view(torch.int32))
        assert torch.equal(mid[n], m1)


@pytest.mark.parametrize("dof", [6, 3], ids=["rv", "v"])
def test_vmap_rule_hands_lanes_to_one_call(request, dof):
    """vmap of minimizer_rv or minimizer_v goes through the op's vmap rule
    (one call over the lanes; on the CPU the plain version lane by lane)
    and equals the lanes one at a time, an unbatched max_s_rho
    expanded."""
    calls = _calls(request, dof)
    drop = ("init_type",) if dof == 6 else ("init_iter", "init_type")
    cfg = {k: v for k, v in calls[0][1].items() if k not in drop}
    st = _stacked(calls)
    msr = calls[0][0][13]
    wrapper = ps.minimizer_rv if dof == 6 else ps.minimizer_v
    n_vel = 2 if dof == 6 else 1          # Vel and W0, or Vel alone

    def solve(*a):
        vel, (f, ik, at, n), rest = a[:n_vel], a[n_vel:n_vel + 4], \
            a[n_vel + 4:]
        extra = dict(min_mod=rest[0]) if rest else {}
        return tuple(wrapper(*vel, ps.SolverMap(*f), ps.FieldView(ik, at),
                             max_s_rho=msr, match_num_min=n, **extra,
                             **cfg))

    args = (*st[:n_vel], st[2:11], st[11], st[12], st[14],
            *([st[MIN_MOD]] if dof == 3 else []))
    before = wrapper.launches
    got = torch.func.vmap(solve)(*args)
    assert wrapper.launches == before      # the CPU launches none
    for n in range(len(calls)):
        one = solve(*[[x[n] for x in a] if isinstance(a, list) else a[n]
                      for a in args])
        for a, b in zip(got, one):
            assert torch.equal(a[n], b)


@pytest.mark.parametrize("dof", [6, 3], ids=["rv", "v"])
def test_launch_refusals(request, dof):
    tensors, cfg = _calls(request, dof)[0]
    bad = list(tensors)
    bad[0] = tensors[0].double()
    with pytest.raises(TypeError, match="Vel"):
        tile_host.pose(bad, dof, **cfg)
    bad = list(tensors)
    bad[12] = tensors[12][:, :6]
    with pytest.raises(ValueError, match="attrs"):
        tile_host.pose(bad, dof, **cfg)
    with pytest.raises(RuntimeError, match="launch failed"):
        tile_host.pose(tensors, dof, **dict(cfg, iter_max=-1))
    # each mode's absent input: W0 at 3 dof, min_mod at 6
    absent, other = (MIN_MOD, 1) if dof == 6 else (1, MIN_MOD)
    bad = _with(tensors, absent, tensors[0].new_zeros(
        tensors[0].shape if absent == 1 else ()))
    with pytest.raises(ValueError, match="takes no"):
        tile_host.pose(bad, dof, **cfg)
    with pytest.raises(TypeError, match=ps._INPUTS[other][0]):
        tile_host.pose(_with(tensors, other, None), dof, **cfg)
    # the other mode's launcher refuses this mode's inputs
    lib = tile_host.library()
    launch = lib.pose_v_launch if dof == 6 else lib.pose_lm_launch
    with pytest.raises(RuntimeError, match="launch failed"):
        ps.pose_launch(launch, tensors, None, dof=dof, **cfg)
