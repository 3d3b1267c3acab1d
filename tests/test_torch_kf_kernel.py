"""K4, the keyframe tracker kernel (`csrc/kf_correct.cu`), run on the CPU
and, marked `card`, on the card.

`tests/tile_host.py` builds the kernel's own source with g++ under the
host emulation of the CUDA subset it uses (`tests/cuda_host_emu.h`: a
thread-block cluster's threads as std::threads, its barrier, each other's
shared memory and the atomics on it) and launches it through the card's
launch path (`kf_tracking.kf_launch`). The inputs are two synthetic maps
of K = 300 slots: keylines on chains of 1 to 10, the frame map the
keyframe map seen 3 px to the right, matches a chain step or two off the
true one, the essential matrices and baseline tests of a real pose
(`kf_tracking._scalars`). Each case changes one thing (see CASES).

Against the plain version (`kf_tracking._body_plain`): m_f, m_kf and the
two counts equal. The plain version runs with an IEEE square root: on the
CPU `torch.sqrt` of float32 is not correctly rounded (about 0.6% of
values differ from the IEEE root in the last bit), while the card's, like
the kernel's, is.

On the card (`python -m pytest --noconftest tests/test_torch_kf_kernel.py
-m card`; this file imports no JAX): K4 at 752x480, K = 16384, on the
calls of real steps, one lane and 16 in one vmapped call, bit for bit
against the plain version there; one launch and one `kf.kernel` count per
step with TrackKeyFrames=1, none with TrackKeyFrames=0.
"""

import numpy as np
import pytest
import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.core.geometry import so3_exp
from rebvo_tpu_torch.frontend import kf_tracking as kft
from rebvo_tpu_torch.frontend import step as step_mod
from rebvo_tpu_torch.frontend.kf_tracking import KFCarry
from rebvo_tpu_torch.frontend.state import KeylineMap
from rebvo_tpu_torch.frontend.step import VOFrontend
from rebvo_tpu_torch.io.render import render_plane_seq

import tile_host

host = pytest.mark.skipif(
    tile_host.compiler() is None,
    reason="the host build of the CUDA kernels needs g++")

torch.set_num_threads(2)

K = 300
ZFM = 458.654                    # EuRoC cam0's focal length, not a float32
KW = dict(zfm=ZFM, dist_thresh=10.0, chain_steps=6, aug_iters=4)
# what each case changes from the base maps: strong_b / strong_f false,
# no keyframe yet (an empty KFCarry), invalid slots that carry match ids,
# keyframe chains whose neighbours lie on one point (exact dn == dp ties),
# chains of one or two keylines (walks end at -1), several new keylines
# matching one old one, no valid slot in either map, and no walk or
# augmentation at all
CASES = ("base", "weak_b", "weak_f", "no_kf", "invalid_ids", "ties",
         "chain_ends", "inversion", "empty", "no_steps")


def _chains(rng, n, max_len):
    """p_id, n_id of n slots on chains of 1 to max_len consecutive slots."""
    p_id = np.full(n, -1, np.int32)
    n_id = np.full(n, -1, np.int32)
    i = 0
    while i < n:
        j = min(n, i + int(rng.integers(1, max_len + 1)))
        n_id[i:j - 1] = np.arange(i + 1, j)
        p_id[i + 1:j] = np.arange(i, j - 1)
        i = j
    return p_id, n_id


def _positions(rng, p_id, ties=False):
    """Keyline coordinates along the chains, a step of ~1.2 px, or, with
    `ties`, alternating between two points (each keyline's neighbours on
    one point)."""
    n = p_id.shape[0]
    px = np.zeros(n, np.float32)
    py = np.zeros(n, np.float32)
    for i in range(n):
        if p_id[i] < 0:
            x, y = rng.uniform(-300, 300), rng.uniform(-200, 200)
            th = rng.uniform(0, np.pi)
            step = (1.2 * np.cos(th), 1.2 * np.sin(th))
            k = 0
        else:
            k += 1
        if ties:
            px[i], py[i] = x + step[0] * (k % 2), y + step[1] * (k % 2)
        else:
            px[i] = x + step[0] * k + rng.normal(0, 0.05)
            py[i] = y + step[1] * k + rng.normal(0, 0.05)
    return px, py


def _map(valid, px, py, p_id, n_id, **ids):
    m = KeylineMap.empty(K, device="cpu")
    t = torch.from_numpy
    return m._replace(valid=t(valid), px=t(px), py=t(py), p_id=t(p_id),
                      n_id=t(n_id), rho=torch.full((K,), 0.5),
                      **{k: t(v.astype(np.int32)) for k, v in ids.items()})


def _matches(rng, valid, p_id, n_id, share=0.7):
    """Each valid slot's match: itself, or a chain step or two off, with
    probability `share`; -1 otherwise."""
    m = np.full(K, -1, np.int64)
    for i in np.flatnonzero(valid):
        if rng.random() < share:
            j = i
            for _ in range(int(rng.integers(0, 3))):
                nxt = (n_id if rng.random() < 0.5 else p_id)[j]
                j = nxt if nxt >= 0 else j
            m[i] = j
    return m


def _case(name, seed=0):
    """(kf, klm, Pose, Pos) of a case."""
    rng = np.random.default_rng(seed)
    n_valid = K - 40
    max_len = 2 if name == "chain_ends" else 10
    p_id, n_id = _chains(rng, n_valid, max_len)
    p_id = np.concatenate([p_id, np.full(K - n_valid, -1, np.int32)])
    n_id = np.concatenate([n_id, np.full(K - n_valid, -1, np.int32)])
    valid = np.arange(K) < n_valid
    valid &= rng.random(K) > 0.05
    kx, ky = _positions(rng, p_id, ties=name == "ties")
    fx = (kx + 3.0 + rng.normal(0, 0.3, K)).astype(np.float32)
    fy = (ky + 0.2 + rng.normal(0, 0.3, K)).astype(np.float32)
    m_id_kf = _matches(rng, valid, p_id, n_id)
    m_id = _matches(rng, valid, p_id, n_id, share=0.8)
    m_id_f = _matches(rng, valid, p_id, n_id)
    if name == "inversion":        # groups of new keylines on one old one
        has = np.flatnonzero(m_id >= 0)
        m_id[has] = m_id[has - has % 4]
    if name == "invalid_ids":
        bad = ~valid
        m_id_kf[bad] = rng.integers(0, K, bad.sum())
        m_id[bad] = rng.integers(0, K, bad.sum())
        m_id_f[bad] = rng.integers(0, K, bad.sum())
    if name == "empty":
        valid[:] = False
        m_id_kf[:] = m_id[:] = m_id_f[:] = -1
    klm = _map(valid, fx, fy, p_id, n_id, m_id_kf=m_id_kf, m_id=m_id)
    kf_klm = _map(valid.copy(), kx, ky, p_id, n_id, m_id_f=m_id_f)
    kf = KFCarry.empty(K, device="cpu")
    if name != "no_kf":
        kf = kf._replace(klm=kf_klm, count=torch.ones((), dtype=torch.int32))
    Pose = so3_exp(torch.tensor([0.01, -0.02, 0.005]))
    Pos = torch.tensor([0.05, 0.005, 0.01])
    return kf, klm, Pose, Pos


def _tensors(name, seed=0):
    kf, klm, Pose, Pos = _case(name, seed)
    E_b, E_f, sb, sf = kft._scalars(kf, klm, Pose, Pos, ZFM, 2.0)
    if name == "empty":            # no valid slot: rho_mean 0; walk anyway
        sb, sf = torch.ones_like(sb), torch.ones_like(sf)
    assert bool(sb) and bool(sf)
    if name == "weak_b":
        sb = torch.zeros_like(sb)
    if name == "weak_f":
        sf = torch.zeros_like(sf)
    return (E_b, E_f, sb, sf, *kft._fields(klm, kf.klm))


def _ieee_sqrt(sqrt):
    def f(x, *a, **kw):
        if x.dtype == torch.float32:
            return sqrt(x.double()).float()
        return sqrt(x, *a, **kw)
    return f


@pytest.fixture
def ieee(monkeypatch):
    """The plain version with the card's (IEEE) float32 root."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt(torch.sqrt))


def _first_step(tensors):
    """dn, dp, d0 of the backward direction's first walk step, as
    chain_correct computes them."""
    E_b, px, py, mkf = tensors[0], tensors[4], tensors[5], tensors[9]
    kf_px, kf_py, kf_pid, kf_nid = tensors[11:15]
    dist = kft._epipolar_dist(px, py, E_b, ZFM, kf_px, kf_py)
    ms = torch.clamp(mkf, min=0)
    nn = torch.where(mkf >= 0, kf_nid[ms], -1)
    pp = torch.where(mkf >= 0, kf_pid[ms], -1)
    return dist(nn), dist(pp), dist(mkf)


@host
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(ieee, name):
    tensors = _tensors(name)
    kw = dict(KW, chain_steps=0, aug_iters=0) if name == "no_steps" else KW
    m_f, m_kf, counts = tile_host.kf(tensors, **kw)
    r_f, r_kf, r_counts = kft._body_plain(*tensors, **kw)
    assert torch.equal(m_kf, r_kf) and torch.equal(m_f, r_f)
    assert torch.equal(counts, r_counts)
    assert counts.tolist() == [int((m_f >= 0).sum()), int((m_kf >= 0).sum())]
    # what each case is there for
    valid, mkf = tensors[8], tensors[9]
    if name == "empty":
        assert counts.tolist() == [0, 0]
    elif name == "no_kf":          # no valid keyframe slot to walk from
        assert int(counts[0]) == 0
    else:
        assert int(counts.min()) > 20, counts
    if name == "weak_b":
        assert torch.equal(m_kf, torch.where(valid, mkf, -1))
    if name == "weak_f":
        assert not torch.equal(m_f, kft._body_plain(
            *tensors[:3], torch.ones_like(tensors[3]), *tensors[4:],
            **kw)[0])
    if name == "base":             # the walks moved ids, the prune cut
        assert int((m_kf != torch.where(valid, mkf, -1)).sum()) > 20
    if name == "invalid_ids":
        assert int(((~valid) & (mkf >= 0)).sum()) > 10
        assert not bool((m_kf[~valid] >= 0).any())
    if name in ("ties", "chain_ends"):
        dn, dp, d0 = _first_step(tensors)
        if name == "ties":
            assert int(((dn == dp) & (dn < d0)).sum()) > 10
        else:
            assert int(((dn == kft.BIG_D) & (dp == kft.BIG_D) &
                        (d0 < kft.BIG_D)).sum()) > 10
    if name == "inversion":
        m_id = tensors[10]
        ids, n = torch.unique(m_id[valid & (m_id >= 0)], return_counts=True)
        assert int((n > 1).sum()) > 10


@host
def test_kernel_matches_plain_through_the_wrapper_path(ieee):
    """The whole block: the scalars then the kernel, against
    correct_and_augment_plain and against the CPU wrapper."""
    kf, klm, Pose, Pos = _case("base", seed=3)
    kw = dict(dist_thresh=10.0, chain_steps=6, aug_iters=4,
              min_baseline_px=2.0)
    ref = kft.correct_and_augment_plain(kf, klm, Pose, Pos, ZFM, **kw)
    via_op = kft.correct_and_augment(kf, klm, Pose, Pos, ZFM, **kw)
    tensors = (*kft._scalars(kf, klm, Pose, Pos, ZFM, 2.0),
               *kft._fields(klm, kf.klm))
    m_f, m_kf, counts = tile_host.kf(tensors, **KW)
    for got in ((m_f, m_kf, counts[0], counts[1]), via_op):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def _stacked(seeds, name="base"):
    return [torch.stack(ts) for ts in zip(*(_tensors(name, s)
                                            for s in seeds))]


@host
def test_lanes_in_one_launch():
    """Three lanes of one launch, one of them weak: each lane's outputs
    equal the lane launched alone."""
    lanes = [_tensors("base", 1), _tensors("weak_b", 2), _tensors("ties", 3)]
    st = [torch.stack(ts) for ts in zip(*lanes)]
    m_f, m_kf, counts = tile_host.kf(st, **KW)
    assert m_f.shape == (3, K) and counts.shape == (3, 2)
    for n, ts in enumerate(lanes):
        o = tile_host.kf(ts, **KW)
        assert torch.equal(m_f[n], o[0]) and torch.equal(m_kf[n], o[1])
        assert torch.equal(counts[n], o[2])


def test_vmap_rule_hands_lanes_to_one_call():
    """vmap of correct_and_augment goes through the op's vmap rule (one
    call over the lanes; on the CPU the plain version lane by lane) and
    equals correct_and_augment_plain lane by lane, an unbatched zfm and
    thresholds shared."""
    cases = [_case("base", s) for s in (4, 5, 6)]
    kf = KFCarry(*[torch.stack(x) if isinstance(x[0], torch.Tensor) else
                   KeylineMap(*[torch.stack(y) for y in zip(*x)])
                   for x in zip(*(c[0] for c in cases))])
    klm = KeylineMap(*[torch.stack(y) for y in zip(*(c[1] for c in cases))])
    Pose = torch.stack([c[2] for c in cases])
    Pos = torch.stack([c[3] for c in cases])
    kw = dict(dist_thresh=10.0, chain_steps=6, aug_iters=4)
    before = kft.correct_and_augment.launches
    got = torch.func.vmap(lambda *a: kft.correct_and_augment(
        *a, ZFM, **kw))(kf, klm, Pose, Pos)
    assert kft.correct_and_augment.launches == before   # the CPU launches none
    for n, c in enumerate(cases):
        one = kft.correct_and_augment_plain(*c, ZFM, **kw)
        for a, b in zip(got, one):
            assert torch.equal(a[n], b)


@host
def test_launch_refusals():
    tensors = _tensors("base")
    bad = list(tensors)
    bad[0] = tensors[0].double()
    with pytest.raises(TypeError, match="E_b"):
        tile_host.kf(bad, **KW)
    bad = list(tensors)
    bad[11] = tensors[11][:-1]
    with pytest.raises(ValueError, match="kf_px"):
        tile_host.kf(bad, **KW)
    bad = list(tensors)
    bad[2] = tensors[2].reshape(1)
    with pytest.raises(ValueError, match="strong_b"):
        tile_host.kf(bad, **KW)
    with pytest.raises(ValueError, match="takes 17 inputs"):
        tile_host.kf(tensors[:-1], **KW)
    with pytest.raises(RuntimeError, match="launch failed"):
        tile_host.kf(tensors, **dict(KW, chain_steps=-1))
    with pytest.raises(RuntimeError, match="launch failed"):
        tile_host.kf(tensors, **dict(KW, aug_iters=-1))
    # more slots than 48 KB of shared memory holds: refused, not run
    big = 49_137
    wide = [t if t.ndim != 1 or t.shape[0] != K else
            t.new_full((big,), -1 if t.dtype == torch.int32 else 0)
            for t in tensors]
    with pytest.raises(RuntimeError, match="launch failed"):
        tile_host.kf(wide, **KW)


SMALL_P = dict(ImageWidth=188, ImageHeight=120, ZfX=100.0, ZfY=100.0,
               PPx=94.0, PPy=60.0, KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0,
               KeylineMax=2048, MaxPoints=2048, ReferencePoints=800,
               TrackPoints=2048, GlobalMatchThreshold=50,
               DetectorThresh=0.03, DetectorAutoGain=1e-6)


def _steps(track, device, n=3):
    """n steps of a 188x120 plane sequence with TrackKeyFrames=`track`:
    the step's calls of the keyframe block, K4's launches and the
    kf.kernel counts over the steps."""
    p = REBVOParameters().replace(**SMALL_P, TrackKeyFrames=track)
    pos = np.zeros((n + 1, 3))
    pos[:, 0] = np.arange(n + 1) * 0.02
    frames = render_plane_seq(n + 1, width=188, height=120, zf=100.0,
                              cx=94.0, cy=60.0, cam_positions=pos,
                              plane_normal=(0.35, 0.25, 1.0), ss=1)
    frames = torch.as_tensor(frames, device=device)
    fe = VOFrontend(p, device=device)
    st = fe.bootstrap(fe.init(), frames[0], 0.0)
    calls = []

    def record(*a, **kw):
        calls.append(a)
        return kft.track_keyframe(*a, **kw)
    step_mod.track_keyframe = record
    l0 = kft.correct_and_augment.launches
    c0 = obs.counters().get("kf.kernel", 0)
    try:
        for i in range(1, n + 1):
            st, _ = fe.step(st, frames[i], i / 20.0)
    finally:
        step_mod.track_keyframe = kft.track_keyframe
    return (len(calls), kft.correct_and_augment.launches - l0,
            obs.counters().get("kf.kernel", 0) - c0)


@pytest.mark.parametrize("track", [0, 1], ids=["off", "on"])
def test_step_calls_the_block_only_when_tracking(track):
    """The mono step runs the keyframe block once a step with
    TrackKeyFrames=1 and never with 0; on the CPU neither launches K4 nor
    counts kf.kernel."""
    calls, launches, counted = _steps(track, "cpu")
    assert calls == 3 * track
    assert launches == 0 and counted == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("K4 is compiled by nvcc and runs on the card only")
    return torch.device("cuda")


@pytest.mark.card
def test_kernel_matches_plain_on_the_card(card):
    """K4 on the calls of 16 steps at 752x480 (K = 16384): each call alone
    and the 16 as lanes of one vmapped call, bit for bit against the plain
    version on the card."""
    n = 16
    p = REBVOParameters()
    pos = np.zeros((n + 1, 3))
    pos[:, 0] = np.arange(n + 1) * 0.02
    frames = torch.as_tensor(render_plane_seq(
        n + 1, cam_positions=pos, plane_normal=(0.35, 0.25, 1.0)),
        device=card)
    fe = VOFrontend(p, device=card)
    calls = []

    def record(kf, klm, fv, Pose, Pos, *a, **kw):
        calls.append((kf, klm, Pose, Pos))
        return kft.track_keyframe(kf, klm, fv, Pose, Pos, *a, **kw)
    step_mod.track_keyframe = record
    try:
        st = fe.bootstrap(fe.init(), frames[0], 0.0)
        for i in range(1, n + 1):
            st, _ = fe.step(st, frames[i], i / p.config_fps)
    finally:
        step_mod.track_keyframe = kft.track_keyframe
    assert len(calls) == n
    kw = dict(dist_thresh=p.KFDistThresh, chain_steps=p.KFChainSteps,
              aug_iters=p.KFAugIters, min_baseline_px=p.KFMinBaselinePx)
    zfm = fe.cam.zfm
    assert calls[0][1].K == 16384
    l0 = kft.correct_and_augment.launches
    for c in calls:
        got = kft.correct_and_augment(*c, zfm, **kw)
        ref = kft.correct_and_augment_plain(*c, zfm, **kw)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert int(got[2]) > 1000 and int(got[3]) > 1000
    stacked = [torch.utils._pytree.tree_map(lambda *x: torch.stack(x), *z)
               for z in zip(*calls)]
    got = torch.func.vmap(lambda *a: kft.correct_and_augment(
        *a, zfm, **kw))(*stacked)
    ref = torch.func.vmap(lambda *a: kft.correct_and_augment_plain(
        *a, zfm, **kw))(*stacked)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert kft.correct_and_augment.launches - l0 == n + 1


@pytest.mark.card
@pytest.mark.parametrize("track", [0, 1], ids=["off", "on"])
def test_launches_per_step_on_the_card(card, track):
    """One K4 launch and one kf.kernel count an eager step with
    TrackKeyFrames=1, none with 0."""
    calls, launches, counted = _steps(track, card)
    assert calls == 3 * track
    assert launches == counted == 3 * track
