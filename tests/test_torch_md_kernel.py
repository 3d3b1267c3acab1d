"""K5, the match-and-depth kernels (`csrc/match_depth.cu`: md_match,
md_depth), run on the CPU and, marked `card`, on the card.

`tests/tile_host.py` builds the kernels' own source with g++ under the
host emulation of the CUDA subset they use (`tests/cuda_host_emu.h`: a
thread-block cluster's threads as std::threads, its barrier, each
other's shared memory, the atomics on it and the warp's shuffle-tree
sum) and launches them through the card's launch paths
(`match_depth.match_launch`, `depth_launch`). The inputs are the stage's
real inputs, recorded from mono steps of a rendered 188x120 sequence on
the CPU (K = 2048), each case changing one thing (MATCH_CASES,
DEPTH_CASES).

Against the plain versions (`match_depth.match_plain`, `depth_plain`):
every output equal, bit for bit. The plain versions run with an IEEE
square root: on the CPU `torch.sqrt` of float32 is not correctly
rounded, while the card's, like the kernels', is.

On the card (`python -m pytest --noconftest tests/test_torch_md_kernel.py
-m card`; this file imports no JAX): the recorded calls of 16 steps at
752x480 (K = 16384), and the cases built from them, each alone and the
16 as lanes of one vmapped call, bit for bit against the plain versions
on the card; one launch of each kernel and one `md.match` and `md.depth`
count per eager step.
"""

import numpy as np
import pytest
import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.core.geometry import so3_exp
from rebvo_tpu_torch.frontend import step as step_mod
from rebvo_tpu_torch.frontend.step import VOFrontend
from rebvo_tpu_torch.io.render import render_plane_seq
from rebvo_tpu_torch.kernels import match_depth as mdk
from rebvo_tpu_torch.kernels.matching import forward_match

import tile_host

host = pytest.mark.skipif(
    tile_host.compiler() is None,
    reason="the host build of the CUDA kernels needs g++")

torch.set_num_threads(2)

SMALL_P = dict(ImageWidth=188, ImageHeight=120, ZfX=100.0, ZfY=100.0,
               PPx=94.0, PPy=60.0, KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0,
               KeylineMax=2048, MaxPoints=2048, ReferencePoints=800,
               TrackPoints=2048, GlobalMatchThreshold=50,
               DetectorThresh=0.03, DetectorAutoGain=1e-6)
# what each case changes from a recorded mono call: several old keylines
# forward-matched to one new one with equal rho (ties to the larger
# index, -0 against +0, a NaN that leaves its target without a winner);
# the VI step's call (no transfer, R0 and a row-major back rotation); no
# motion (norm_t0 = 0: the gradient direction); nan_fail (est_ok false);
# a rotation that turns part of the map behind the camera (qz <= 0); no
# valid slot in either map
MATCH_CASES = ("mono", "ties", "vi", "still", "nan_fail", "qz", "empty")
# a recorded mono call; the VI step's apply_res branch (ImuMode > 0, a
# bootstrap frame, Kp far from 1); the stereo split (no rescaling, the
# previous P_Kp carried), and with too few matches; nan_fail and too few
# matches (the select keeps the matched map); no valid slot
DEPTH_CASES = ("mono", "vi", "stereo", "stereo_fail", "nan_fail",
               "match_fail", "empty")
# the lane axis of each output: the rows are field-major
MATCH_DIMS = (1, 1, 0, 0, 0)
DEPTH_DIMS = (1, 0)


def _record(p, device, n, width, height, zf, cx, cy):
    """The (match, depth) op inputs of n mono steps of a rendered plane
    sequence: [((tensors, keywords), (tensors, keywords)), ...]."""
    pos = np.zeros((n + 1, 3))
    pos[:, 0] = np.arange(n + 1) * 0.02
    frames = torch.as_tensor(render_plane_seq(
        n + 1, width=width, height=height, zf=zf, cx=cx, cy=cy,
        cam_positions=pos, plane_normal=(0.35, 0.25, 1.0),
        ss=1 if width < 400 else 3), device=device)
    fe = VOFrontend(p, device=device)
    calls = []
    orig_m, orig_d = step_mod.md_match, step_mod.md_depth

    def rec_m(*a, **kw):
        calls.append([mdk.match_args(*a, **kw)])
        return orig_m(*a, **kw)

    def rec_d(*a, **kw):
        calls[-1].append(mdk.depth_args(*a, **kw))
        return orig_d(*a, **kw)
    step_mod.md_match, step_mod.md_depth = rec_m, rec_d
    try:
        st = fe.bootstrap(fe.init(), frames[0], 0.0)
        for i in range(1, n + 1):
            st, _ = fe.step(st, frames[i], i / p.config_fps)
    finally:
        step_mod.md_match, step_mod.md_depth = orig_m, orig_d
    return calls


@pytest.fixture(scope="module")
def recorded():
    p = REBVOParameters().replace(**SMALL_P)
    return _record(p, "cpu", 3, 188, 120, 100.0, 94.0, 60.0)


def _clone(ts):
    return [([t.clone() for t in x] if isinstance(x, list) else
             None if x is None else x.clone()) for x in ts]


def match_case(name, call):
    """md_match's (tensors, keywords) of a case, from a recorded call."""
    ts, kw = call
    ts = _clone(ts)
    kw = dict(kw)
    old, m_id_f, new, field, vel, p_v, w, r0, br, nan_fail = ts
    OI, NI = mdk.OLD_FIELDS.index, mdk.NEW_FIELDS.index
    if name == "ties":
        # groups of four valid old keylines on one target, rho equal within
        # a group; one group at -0 and +0, one with a NaN
        src = torch.nonzero(old[OI("valid")] & (m_id_f >= 0))[:, 0]
        src = src[:(len(src) // 4) * 4].reshape(-1, 4)
        rho = old[OI("rho")]
        m_id_f[src] = m_id_f[src[:, :1]]
        rho[src] = rho[src[:, :1]]
        rho[src[0, :2]] = -0.0
        rho[src[0, 2:]] = 0.0
        rho[src[1, 1]] = float("nan")
    elif name == "vi":
        # the VI step's forward transfer runs before the stage
        om = mdk._partial_map(mdk.OLD_FIELDS, old)
        nm = mdk._partial_map(mdk.NEW_FIELDS, new)
        nm, _ = forward_match(om, nm, m_id_f)
        new = [getattr(nm, f) for f in mdk.NEW_FIELDS]
        r0 = so3_exp(w)
        br = (so3_exp(torch.tensor([0.002, -0.001, 0.003],
                                   device=w.device)) @ r0.T).contiguous()
        m_id_f, w = None, None
    elif name == "still":
        vel = torch.zeros_like(vel)
    elif name == "nan_fail":
        nan_fail = torch.ones_like(nan_fail)
    elif name == "qz":
        w = torch.tensor([0.1, 1.9, -0.2], device=w.device)
    elif name == "empty":
        old[OI("valid")] = torch.zeros_like(old[OI("valid")])
        new[NI("valid")] = torch.zeros_like(new[NI("valid")])
        m_id_f = torch.full_like(m_id_f, -1)
    return (old, m_id_f, new, field, vel, p_v, w, r0, br, nan_fail), kw


def unpoisoned(ts):
    """md_match's inputs with no forward match into a target that a valid
    NaN-rho source aims at: what the CPU's plain scatter, and the
    kernel, make of the NaN (that target gets no winner)."""
    old, m_id_f = ts[0], ts[1].clone()
    OI = mdk.OLD_FIELDS.index
    src = old[OI("valid")] & (m_id_f >= 0)
    bad = m_id_f[src & torch.isnan(old[OI("rho")])]
    m_id_f[src & torch.isin(m_id_f, bad)] = -1
    return (old, m_id_f) + tuple(ts[2:])


def depth_case(name, call):
    """md_depth's (tensors, keywords) of a case, from a recorded call."""
    ts, kw = call
    ts = _clone(ts)
    kw = dict(kw)
    klm, vel, nan_fail, nmatch, frame_count, p_kp = ts
    DI = mdk.DEPTH_FIELDS.index
    if name == "vi":
        kw.update(imu_boot=True, brf=20)
        frame_count = torch.full_like(frame_count, 5)
        # a map too near by half: the EKF's update moves rho off its
        # prediction, Kp off 1
        klm[DI("rho")] = klm[DI("rho")] * 1.5
    elif name in ("stereo", "stereo_fail"):
        kw.update(rescale=False)
        p_kp = torch.full_like(p_kp, 0.375)
        if name == "stereo_fail":
            nmatch = torch.full_like(nmatch, kw["gmt"] - 1)
    elif name == "nan_fail":
        nan_fail = torch.ones_like(nan_fail)
    elif name == "match_fail":
        nmatch = torch.full_like(nmatch, kw["gmt"] - 1)
    elif name == "empty":
        klm[DI("valid")] = torch.zeros_like(klm[DI("valid")])
    return (klm, vel, nan_fail, nmatch, frame_count, p_kp), kw


def _vmapped(fn, stacked, kw):
    """`fn(*inputs, **kw)` vmapped over the stacked inputs' first axis."""
    in_dims = tuple(None if x is None else 0 for x in stacked)
    return torch.func.vmap(lambda *a: fn(*a, **kw), in_dims=in_dims)(
        *stacked)


def _ieee_sqrt(sqrt):
    def f(x, *a, **kw):
        if x.dtype == torch.float32:
            return sqrt(x.double()).float()
        return sqrt(x, *a, **kw)
    return f


@pytest.fixture
def ieee(monkeypatch):
    """The plain versions with the card's (IEEE) float32 root."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt(torch.sqrt))


def _equal(got, ref):
    """Each output equal bit for bit (a NaN equal to a NaN)."""
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                int((a.view(torch.int32) != b.view(torch.int32)).sum())
        else:
            assert torch.equal(a, b), int((a != b).sum())


@host
@pytest.mark.parametrize("name", MATCH_CASES)
def test_md_match_matches_plain(ieee, recorded, name):
    ts, kw = match_case(name, recorded[-1][0])
    got = tile_host.md_match(*ts, **kw)
    ref = mdk.match_plain(*ts, **kw)
    _equal(got, ref)
    out_f, out_i, r0, nmatch, est_ok = got
    # what each case is there for
    mid = out_i[mdk.MATCH_INT_ROWS.index("m_id")]
    if name == "empty":
        assert int(nmatch) == 0 and not bool(est_ok)
    elif name != "qz":                 # half the map behind the camera
        assert int(nmatch) > 200, int(nmatch)
    if name in ("mono", "still", "qz"):
        assert bool(est_ok) == (name != "qz" or int(nmatch) >= kw["gmt"])
    if name == "nan_fail":
        assert not bool(est_ok) and int(nmatch) >= kw["gmt"]
    if name == "ties":
        # each group's winner is its largest index (the NaN group: none)
        old, m_id_f = ts[0], ts[1]
        fwd, _ = forward_match(mdk._partial_map(mdk.OLD_FIELDS, old),
                               mdk._partial_map(mdk.NEW_FIELDS, ts[2]),
                               m_id_f)
        src = torch.nonzero(old[0] & (m_id_f >= 0))[:, 0]
        tgt = m_id_f[src]
        n_nan = 0
        for t in tgt.unique()[:50]:
            group = src[tgt == t]
            rho = old[mdk.OLD_FIELDS.index("rho")][group]
            if torch.isnan(rho).any():
                n_nan += 1
                assert int(fwd.m_id[t]) != int(group.max())
            else:
                assert int(fwd.m_id[t]) == int(group.max())
        assert n_nan == 1
    if name == "still":
        assert float(ts[4].abs().max()) == 0.0
    if name == "qz":
        old = ts[0]
        R0 = so3_exp(ts[6])
        px, py = old[1], old[2]
        qz = R0[2, 0] * px / kw["zfm"] + R0[2, 1] * py / kw["zfm"] + R0[2, 2]
        assert int((qz <= 0).sum()) > 50 and int((qz > 0).sum()) > 50
    if name == "vi":
        assert ts[1] is None and ts[6] is None
        assert ts[8].is_contiguous()
    assert int((mid >= 0).sum()) >= int(nmatch)


@host
def test_nan_rho_leaves_its_target_without_a_winner(ieee, recorded):
    """A valid old keyline with a NaN rho, forward-matched: its target
    takes no transfer from any source, in the plain version on the CPU
    and in the kernel, as if no source aimed at it (the card's plain
    scatter may differ there, test_kernels_match_plain_on_the_card)."""
    ts, kw = match_case("ties", recorded[-1][0])
    clean = unpoisoned(ts)
    assert int((clean[1] != ts[1]).sum()) == 4       # the NaN's group
    ref = mdk.match_plain(*clean, **kw)
    _equal(mdk.match_plain(*ts, **kw), ref)
    _equal(tile_host.md_match(*ts, **kw), ref)


@host
@pytest.mark.parametrize("name", DEPTH_CASES)
def test_md_depth_matches_plain(ieee, recorded, name):
    ts, kw = depth_case(name, recorded[-1][1])
    got = tile_host.md_depth(*ts, **kw)
    ref = mdk.depth_plain(*ts, **kw)
    _equal(got, ref)
    rows, s = got
    klm = ts[0]
    DI = mdk.DEPTH_FIELDS.index
    same = all(torch.equal(rows[i], klm[DI(f)])
               for i, f in enumerate(mdk.DEPTH_ROWS))
    # what each case is there for
    if name in ("nan_fail", "match_fail"):
        assert same                    # the select keeps the matched map
        assert float(s[2]) == float(np.float32(1e18) if name == "nan_fail"
                                    else 10.0)
        assert float(s[0]) == 1.0 and float(s[3:].abs().max()) == 0.0
    elif name == "empty":
        assert same and float(s[0]) == 1.0
    elif name.startswith("stereo"):
        # the filtered map unselected; Kp = 1 and the previous P_Kp, or
        # 10 and no velocity on a failed match
        ok = name == "stereo"
        assert not same and float(s[0]) == float(s[1]) == 1.0
        assert float(s[2]) == (0.375 if ok else 10.0)
        assert torch.equal(s[3:], ts[1] if ok else torch.zeros_like(ts[1]))
    else:
        assert not same
    if name == "vi":                   # apply_res: the map divided by Kp
        assert abs(float(s[0]) - 1.0) > 0.05 and float(s[1]) == 1.0
    if name == "mono":
        assert float(s[1]) == float(s[0])


def _stack(items):
    """The op inputs of several lanes stacked (lists field by field, None
    kept)."""
    return [None if x[0] is None else
            [torch.stack(y) for y in zip(*x)] if isinstance(x[0], list)
            else torch.stack(x) for x in zip(*items)]


@host
def test_lanes_in_one_launch(recorded):
    """Lanes of one launch (three cases each kernel, the keywords
    shared): each lane's outputs equal the lane launched alone; the rows
    come back field-major."""
    for run, names, case, call, dims in (
            (tile_host.md_match, ("mono", "still", "ties"), match_case,
             recorded[-1][0], MATCH_DIMS),
            (tile_host.md_depth, ("mono", "nan_fail", "match_fail"),
             depth_case, recorded[-1][1], DEPTH_DIMS)):
        lanes = [case(n, call) for n in names]
        kw = lanes[0][1]
        got = run(*_stack([ts for ts, _ in lanes]), **kw)
        for n, (ts, _) in enumerate(lanes):
            one = run(*ts, **kw)
            _equal([a.select(d, n) for a, d in zip(got, dims)], one)


def test_vmap_rule_hands_lanes_to_one_call(recorded):
    """vmap of md_match and md_depth goes through the ops' vmap rules
    (one call over the lanes; on the CPU the plain versions lane by lane)
    and equals the plain versions lane by lane, the keywords shared."""
    calls = recorded
    m0, d0 = mdk.md_match.launches, mdk.md_depth.launches
    for i in (0, 1):
        op = (mdk._match_op, mdk._depth_op)[i]
        plain = (mdk.match_plain, mdk.depth_plain)[i]
        kw = calls[0][i][1]
        got = _vmapped(op, _stack([c[i][0] for c in calls]), kw)
        for n, c in enumerate(calls):
            for a, b in zip(got, plain(*c[i][0], **kw)):
                assert torch.equal(a[n], b)
    # the CPU launches none
    assert (mdk.md_match.launches, mdk.md_depth.launches) == (m0, d0)


@host
def test_launch_refusals(recorded):
    ts, kw = match_case("mono", recorded[-1][0])
    old = list(ts[0])

    def with_old(i, t):
        o = list(old)
        o[i] = t
        return (o,) + tuple(ts[1:])
    with pytest.raises(TypeError, match="old.px"):
        tile_host.md_match(*with_old(1, old[1].double()), **kw)
    with pytest.raises(ValueError, match="old.py"):
        tile_host.md_match(*with_old(2, old[2][:-1]), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tile_host.md_match(*with_old(3, torch.stack([old[3]] * 2, -1)[:, 0]),
                           **kw)
    with pytest.raises(ValueError, match="is on meta"):
        tile_host.md_match(*with_old(4, old[4].to("meta")), **kw)
    with pytest.raises(ValueError, match="W, or R0 and BackRot"):
        tile_host.md_match(*ts[:6], None, None, None, ts[9], **kw)
    with pytest.raises(ValueError, match="takes 15 old"):
        tile_host.md_match(old[:-1], *ts[1:], **kw)
    with pytest.raises(RuntimeError, match="md_match kernel launch failed"):
        tile_host.md_match(*ts, **dict(kw, max_steps=-1))
    # more slots than 48 KB of shared memory holds: refused, not run
    big = 49_000
    wide = [t.new_zeros(big) for t in old]
    with pytest.raises(RuntimeError, match="md_match kernel launch failed"):
        tile_host.md_match(wide, torch.full((big,), -1, dtype=torch.int32),
                           [t.new_zeros(big) for t in ts[2]], *ts[3:], **kw)
    dts, dkw = depth_case("mono", recorded[-1][1])
    klm = list(dts[0])
    klm[1] = klm[1].float()
    with pytest.raises(TypeError, match="n_id"):
        tile_host.md_depth(klm, *dts[1:], **dkw)
    with pytest.raises(ValueError, match="nmatch has shape"):
        tile_host.md_depth(dts[0], dts[1], dts[2], dts[3][None], dts[4],
                           dts[5], **dkw)
    with pytest.raises(TypeError, match="P_Kp"):
        tile_host.md_depth(*dts[:5], dts[5].double(), **dkw)
    with pytest.raises(ValueError, match="takes 19 map fields"):
        tile_host.md_depth(dts[0][:-1], *dts[1:], **dkw)


def test_step_calls_each_kernel_once_a_step(recorded):
    """A mono step calls md_match and md_depth once each; on the CPU
    neither launches nor counts md.match / md.depth."""
    assert len(recorded) == 3 and all(len(c) == 2 for c in recorded)
    p = REBVOParameters().replace(**SMALL_P)
    c0 = obs.counters()
    _record(p, "cpu", 1, 188, 120, 100.0, 94.0, 60.0)
    c1 = obs.counters()
    for k in ("md.match", "md.depth"):
        assert c1.get(k, 0) == c0.get(k, 0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("K5 is compiled by nvcc and runs on the card only")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_calls(card):
    p = REBVOParameters()
    return _record(p, card, 16, p.ImageWidth, p.ImageHeight, p.ZfX, p.PPx,
                   p.PPy)


@pytest.mark.card
def test_kernels_match_plain_on_the_card(card, card_calls):
    """K5 on the calls of 16 steps at 752x480 (K = 16384) and on every
    case built from the last: each call alone, and the 16 calls as lanes
    of one vmapped call, bit for bit against the plain versions on the
    card."""
    calls = card_calls
    assert calls[0][0][0][0][0].shape[-1] == 16384
    m0, d0 = mdk.md_match.launches, mdk.md_depth.launches
    for (mts, mkw), (dts, dkw) in calls:
        _equal(mdk._match_op(*mts, **mkw), mdk.match_plain(*mts, **mkw))
        _equal(mdk._depth_op(*dts, **dkw), mdk.depth_plain(*dts, **dkw))
    for name in MATCH_CASES:
        ts, kw = match_case(name, calls[-1][0])
        # the NaN-rho source's target: the kernel keeps the CPU's rule (no
        # winner), which the card's plain scatter need not
        ref = unpoisoned(ts) if name == "ties" else ts
        _equal(mdk._match_op(*ts, **kw), mdk.match_plain(*ref, **kw))
    for name in DEPTH_CASES:
        ts, kw = depth_case(name, calls[-1][1])
        _equal(mdk._depth_op(*ts, **kw), mdk.depth_plain(*ts, **kw))
    n = len(calls)
    assert mdk.md_match.launches - m0 == n + len(MATCH_CASES)
    assert mdk.md_depth.launches - d0 == n + len(DEPTH_CASES)
    # the 16 calls as 16 lanes: one launch each
    mkw, dkw = calls[0][0][1], calls[0][1][1]
    mst = _stack([c[0][0] for c in calls])
    dst = _stack([c[1][0] for c in calls])
    _equal(_vmapped(mdk._match_op, mst, mkw),
           _vmapped(mdk.match_plain, mst, mkw))
    _equal(_vmapped(mdk._depth_op, dst, dkw),
           _vmapped(mdk.depth_plain, dst, dkw))
    assert mdk.md_match.launches - m0 == n + len(MATCH_CASES) + 1
    assert mdk.md_depth.launches - d0 == n + len(DEPTH_CASES) + 1


@pytest.mark.card
def test_launches_per_step_on_the_card(card):
    """One md_match and one md_depth launch, and one md.match and
    md.depth count, an eager mono step."""
    p = REBVOParameters().replace(**SMALL_P)
    m0, d0 = mdk.md_match.launches, mdk.md_depth.launches
    c0 = obs.counters()
    calls = _record(p, card, 3, 188, 120, 100.0, 94.0, 60.0)
    c1 = obs.counters()
    assert len(calls) == 3
    assert mdk.md_match.launches - m0 == mdk.md_depth.launches - d0 == 3
    for k in ("md.match", "md.depth"):
        assert c1.get(k, 0) - c0.get(k, 0) == 3
