"""The offline-BA path of the port against the JAX package's, on the CPU:
backend/ba.py (the synthetic problems, the per-observation residuals and
Jacobians, the block sums, the Schur solve, ba_solve, partition_problem,
problem_from_keyframes), run_vo --kf-every / --save-kf, and run_ba end
to end.

Tolerances. Residuals, Jacobians and the block sums agree within float32
roundoff (rtol 1e-5 of each array's largest entry). The BA's reduced
camera system leaves the monocular scale gauge to the damping alone
(condition number ~3e7 at damping 1e-3), so a float32 roundoff moves a
Gauss-Newton step along the gauge by tens of percent: whole solves are
compared by their first cost (rtol 1e-5), their final cost (rtol 1e-3)
and the similarity-aligned distance between their poses (1e-5 of the
trajectory's extent), and the Schur solve alone at damping 1, where the
system is conditioned (rtol 1e-3). Integer outputs of
problem_from_keyframes (landmark and observation masks, ids) must be
equal; its float outputs agree within 1e-4 px (the matched keyline's
coordinates are gathers; the pose transport is float32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebvo_tpu.backend import ba as jba
from rebvo_tpu.backend import keyframe as jkf
from rebvo_tpu_torch.backend import ba as tba
from rebvo_tpu_torch.backend import keyframe as tkf
from rebvo_tpu_torch.config import REBVOParameters, save_config
from rebvo_tpu_torch.convert import (ba_problem_from_numpy,
                                     keyframe_store_from_numpy)
from rebvo_tpu_torch.io.png import write_png
from rebvo_tpu_torch.io.render import render_billboards_seq
from rebvo_tpu_torch.io.trajectory import ate_rmse
from tests.test_backend import (ZFM, make_ba_problem, perturb,
                                synthetic_kf_store)

torch.set_num_threads(2)

RING_ZFM = 200.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tp(prob):
    return ba_problem_from_numpy(_np(prob), device="cpu")


def close_rel(a, b, rtol=1e-5):
    """b within rtol of a's largest entry, element by element."""
    a = np.asarray(a, np.float64)
    b = b.numpy().astype(np.float64) if isinstance(b, torch.Tensor) else b
    scale = max(float(np.abs(a).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= rtol * scale, \
        (float(np.abs(a - b).max()), scale)


def _ring(F=6, L=48, obs_per=3):
    """The JAX package's ring problem, poses perturbed as in
    tests/test_ba_scale.py."""
    R_true, p_true, rho_true, jp = jba.synth_ring_problem(F, L, obs_per,
                                                          RING_ZFM)
    rng = np.random.RandomState(1)
    p0 = p_true + rng.randn(*p_true.shape).astype(np.float32) * 0.02
    return R_true, p_true, p0, jp


def test_synth_ring_problem_is_the_jax_problem():
    a = jba.synth_ring_problem(6, 48, 3, RING_ZFM, seed=3, rho_noise=0.2)
    b = tba.synth_ring_problem(6, 48, 3, RING_ZFM, seed=3, rho_noise=0.2,
                               device="cpu")
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(x, y)
    for name, x, y in zip(jba.BAProblem._fields, a[3], b[3]):
        assert y.dtype == torch.as_tensor(np.array(x)).dtype, name
        assert np.array_equal(np.asarray(x), y.numpy()), name


def _clamped_ring():
    """The ring problem with some landmarks behind the camera and some so
    near that the depth clamp (|z| < 0.05) holds."""
    R_true, p_true, p0, jp = _ring()
    rho = np.asarray(jp.rho).copy()
    rho[:4] = -2.0
    rho[4:8] = 40.0
    return R_true, p0, jp._replace(rho=jnp.asarray(rho))


@pytest.mark.parametrize("case", ["ring", "clamped", "anchored"])
def test_build_terms_match_jax(case):
    """r, the 6+6+1 Jacobian and the robust weight of every observation
    (Huber k=1 so that some weights are cut)."""
    if case == "ring":
        R, _, p, jp = _ring()
    elif case == "clamped":
        R, p, jp = _clamped_ring()
    else:
        R_true, p_true, rho_true, jp = make_ba_problem(noise_px=0.3)
        R, p, rho0 = perturb(R_true, p_true, rho_true)
        jp = jp._replace(rho=rho0)
    R, p = np.array(R, np.float32), np.array(p, np.float32)
    zfm = ZFM if case == "anchored" else RING_ZFM
    a = jba._build_terms(jnp.asarray(R), jnp.asarray(p), jp,
                         jnp.asarray(zfm), 1.0)
    b = tba._build_terms(torch.as_tensor(R), torch.as_tensor(p), _tp(jp),
                         zfm, 1.0)
    for x, y in zip(a, b):
        close_rel(x, y)
    wgt = b[4].numpy()
    assert (wgt < 1.0).any() and (wgt > 0).any()


def test_reduce_terms_match_jax():
    """H [6F,6F], b, h_l, g_l, S [L,6F] and the cost from the same terms."""
    R, _, p, jp = _ring()
    terms = jba._build_terms(jnp.asarray(R), jnp.asarray(p), jp,
                             jnp.asarray(RING_ZFM), 3.0)
    a = jba._reduce_terms(*terms, jp, 6)
    b = tba._reduce_terms(*[torch.as_tensor(np.array(x)) for x in terms],
                          _tp(jp), 6)
    for name, x, y in zip(("H", "b", "h_l", "g_l", "S", "cost"), a, b):
        assert tuple(y.shape) == tuple(np.shape(x)), name
        close_rel(x, y)
    H = b[0].numpy()
    assert np.allclose(H, H.T, rtol=0, atol=1e-6 * np.abs(H).max())


@pytest.mark.parametrize("damping", [1.0, 1e-3])
def test_schur_solve_matches_jax(damping):
    """The reduced solve from the same blocks: at damping 1 dx and drho
    agree; at the solver's 1e-3, where the gauge leaves the system
    ill-conditioned, each solution satisfies its reduced system."""
    R, _, p, jp = _ring()
    terms = jba._build_terms(jnp.asarray(R), jnp.asarray(p), jp,
                             jnp.asarray(RING_ZFM), 3.0)
    blocks = [np.array(x) for x in jba._reduce_terms(*terms, jp, 6)][:5]
    dx_j, dr_j = jba._schur_solve(*[jnp.asarray(x) for x in blocks], 6,
                                  jnp.asarray(damping, jnp.float32))
    dx_t, dr_t = tba._schur_solve(*[torch.as_tensor(x) for x in blocks], 6,
                                  torch.tensor(damping))
    assert float(dx_t[:6].abs().max()) == 0.0          # the pinned pose
    if damping == 1.0:
        close_rel(dx_j, dx_t, rtol=1e-3)
        close_rel(dr_j, dr_t, rtol=1e-3)
    H, b, h_l, g_l, S = [x.astype(np.float64) for x in blocks]
    inv_h = np.where(h_l > 1e-12, 1.0 / (h_l + damping), 0.0)
    H_red = H - (S * inv_h[:, None]).T @ S + np.eye(36) * damping
    b_red = b - S.T @ (inv_h * g_l)
    for dx in (np.asarray(dx_j), dx_t.numpy()):
        res = H_red[6:, 6:] @ dx[6:].astype(np.float64) + b_red[6:]
        assert np.abs(res).max() <= 1e-3 * np.abs(b_red[6:]).max()


def test_ba_solve_matches_jax():
    """tests/test_backend.py's anchored problem (landmarks in keyframe 0,
    0.1 px noise, perturbed poses and depths), 10 iterations: the same
    first cost and floor, poses equal up to the gauge, and the port meets
    the JAX test's bars against the truth."""
    R_true, p_true, rho_true, prob = make_ba_problem(noise_px=0.1)
    R0, p0, rho0 = perturb(R_true, p_true, rho_true)
    jp = prob._replace(rho=rho0)
    Rj, pj, rj, cj = jba.ba_solve(R0, p0, jp, jnp.asarray(ZFM), iters=10)
    Rt, pt, rt, ct = tba.ba_solve(torch.as_tensor(np.array(R0)),
                                  torch.as_tensor(np.array(p0)), _tp(jp),
                                  ZFM, iters=10)
    cj, ct = np.asarray(cj), ct.numpy()
    assert ct.shape == (10,) and np.all(np.isfinite(ct))
    np.testing.assert_allclose(ct[0], cj[0], rtol=1e-5)
    np.testing.assert_allclose(ct[-1], cj[-1], rtol=1e-3)
    assert ct[-1] < ct[0] * 0.01
    ext = np.ptp(p_true, axis=0).max()
    assert ate_rmse(pt.numpy(), np.asarray(pj)) < 1e-5 * ext
    ate0 = ate_rmse(np.asarray(p0), p_true)
    assert ate_rmse(pt.numpy(), p_true) < max(ate0 * 0.35, 2e-3)
    lg = np.log(rt.numpy() / rho_true)
    lg0 = np.log(np.asarray(rho0) / rho_true)
    assert np.abs(lg - np.median(lg)).mean() < max(
        np.abs(lg0 - np.median(lg0)).mean() * 0.35, 5e-3)


def test_ba_solve_ring_matches_jax():
    """The ring problem of tests/test_ba_scale.py at 6 keyframes, 4
    iterations: the same first cost, both at the floor, poses equal up to
    the gauge."""
    R, p_true, p0, jp = _ring()
    _, pj, _, cj = jba.ba_solve(jnp.asarray(R), jnp.asarray(p0), jp,
                                jnp.asarray(RING_ZFM), iters=4)
    _, pt, _, ct = tba.ba_solve(torch.as_tensor(R), torch.as_tensor(p0),
                                _tp(jp), RING_ZFM, iters=4)
    cj, ct = np.asarray(cj), ct.numpy()
    np.testing.assert_allclose(ct[0], cj[0], rtol=1e-5)
    assert ct[-1] < 1e-3 * ct[0] and cj[-1] < 1e-3 * cj[0]
    assert ate_rmse(pt.numpy(), np.asarray(pj)) < 1e-4


def test_partition_problem_matches_jax():
    """tests/test_ba_scale.py's deliberately non-divisible layout."""
    rng = np.random.RandomState(3)
    L, O, S = 37, 211, 8
    jp = jba.BAProblem(
        anchor=rng.randint(0, 4, L).astype(np.int32),
        lpx=rng.randn(L).astype(np.float32),
        lpy=rng.randn(L).astype(np.float32),
        rho=rng.uniform(0.2, 1.0, L).astype(np.float32),
        lvalid=np.ones((L,), bool),
        obs_lm=rng.randint(0, L, O).astype(np.int32),
        obs_kf=rng.randint(0, 4, O).astype(np.int32),
        mx=np.arange(O, dtype=np.float32),
        my=rng.randn(O).astype(np.float32),
        ux=np.ones(O, np.float32), uy=np.zeros(O, np.float32),
        w=np.ones((O,), np.float32), ovalid=rng.rand(O) > 0.2)
    a = jba.partition_problem(jp, S)
    b = tba.partition_problem(_tp(jp), S)
    for name, x, y in zip(jba.BAProblem._fields, a, b):
        assert np.array_equal(np.asarray(x), y.numpy()), name


# ---------------------------------------------------------------------------
# keyframe stores: run_vo --kf-every of both packages, problem_from_keyframes
# ---------------------------------------------------------------------------

KF_W, KF_H, KF_ZF = 376, 240, 200.0
KF_FRAMES, KF_EVERY = 16, 5


@pytest.fixture(scope="module")
def kf_runs(tmp_path_factory):
    """Both run_vo's --kf-every 5 --save-kf on 16 rendered 376x240 frames
    of a lateral path (a DataSetCam directory the config names)."""
    from rebvo_tpu.apps import run_vo as jrv
    from rebvo_tpu_torch.apps import run_vo as trv
    d = tmp_path_factory.mktemp("kf_runs")
    os.makedirs(d / "data")
    pos = np.zeros((KF_FRAMES, 3))
    pos[:, 0] = np.arange(KF_FRAMES) * 0.01
    frames = render_billboards_seq(KF_FRAMES, width=KF_W, height=KF_H,
                                   zf=KF_ZF, cx=KF_W / 2, cy=KF_H / 2,
                                   cam_positions=pos, seed=3, ss=1)
    lines = []
    for i, f in enumerate(frames):
        write_png(str(d / "data" / f"{i:06d}.png"),
                  np.clip(f / 3.0, 0, 255).astype(np.uint8))
        lines.append(f"{int(round(i / 20.0 * 1e9))},{i:06d}.png")
    (d / "data.csv").write_text("#timestamp [ns],filename\n" +
                                "\n".join(lines) + "\n")
    p = REBVOParameters().replace(
        ImageWidth=KF_W, ImageHeight=KF_H, ZfX=KF_ZF, ZfY=KF_ZF,
        PPx=KF_W / 2, PPy=KF_H / 2, KcR2=0.0, KcR4=0.0, KcR6=0.0,
        KcP1=0.0, KcP2=0.0, useUndistort=0,
        DataSetDir=str(d / "data") + "/",
        DataSetFile=str(d / "data.csv"), CamTimeScale=1e-9)
    cfg = str(d / "run.cfg")
    save_config(p, cfg)
    mp = pytest.MonkeyPatch()
    mp.setenv("REBVO_COMPILE_CACHE", str(d / "jax_cache"))
    try:
        for mod, tag in ((jrv, "j"), (trv, "t")):
            mod.main(["--cpu", "--config", cfg, "--out-dir", str(d / tag),
                      "--kf-every", str(KF_EVERY), "--save-kf",
                      str(d / f"{tag}_kf.npz")])
    finally:
        mp.undo()
    return dict(dir=d, params=p, jax=str(d / "j_kf.npz"),
                port=str(d / "t_kf.npz"))


def test_run_vo_kf_every_store_matches_jax(kf_runs):
    """The port's store has the JAX store's keys, shapes and dtypes; the
    same slots hold keyframes, at the same times, each the state of its
    frame (its Pos is the trajectory's row at that time, within 1e-6).
    The JAX run_vo detects with separate ops on the CPU and the port with
    the fused detector's plain version, whose keyline counts differ by
    one or two (ROADMAP queue 3), and mono VO's scale carries that
    on: the keyframes' positions agree within 2% of the trajectory's
    extent after similarity alignment (measured 0.8%), as the
    trajectories do (0.9%), and their keyline counts within 0.1%."""
    from rebvo_tpu_torch.io.trajectory import read_tum
    d, p = kf_runs["dir"], kf_runs["params"]
    zj, zt = np.load(kf_runs["jax"]), np.load(kf_runs["port"])
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
    cap = KF_FRAMES // KF_EVERY + 2
    assert zt["valid"].shape == (cap,)
    assert np.array_equal(zt["valid"], zj["valid"])
    assert int(zt["count"]) == int(zj["count"]) == 3
    np.testing.assert_array_equal(zt["t"], zj["t"])
    live = zt["valid"]
    trajs = {}
    for z, tag in ((zj, "j"), (zt, "t")):
        ts, pos, _ = read_tum(str(d / tag / p.TrayFile))
        trajs[tag] = pos
        for k in np.nonzero(live)[0]:
            row = int(np.argmin(np.abs(ts - z["t"][k])))
            np.testing.assert_allclose(z["Pos"][k], pos[row], atol=1e-6)
    ext = np.ptp(trajs["j"], axis=0).max()
    assert ext > 0
    assert ate_rmse(trajs["t"], trajs["j"]) < 0.02 * ext
    assert ate_rmse(zt["Pos"][live], zj["Pos"][live]) < 0.02 * ext
    nj, nt = zj["klm_valid"].sum(1), zt["klm_valid"].sum(1)
    assert np.all(np.abs(nt - nj) <= 1e-3 * nj) and nt[live].min() > 1000


def test_run_vo_save_kf_is_accepted(tmp_path):
    """--save-kf is a flag of the port's run_vo (it used to exit 2 with
    "unrecognized arguments"): the store lands at the given path."""
    from rebvo_tpu_torch.apps import run_vo as trv
    p = REBVOParameters().replace(ImageWidth=96, ImageHeight=64, PPx=48.0,
                                  PPy=32.0, KeylineMax=512, MaxPoints=512,
                                  useUndistort=0)
    cfg = str(tmp_path / "small.cfg")
    save_config(p, cfg)
    out = tmp_path / "kf" / "store.npz"
    os.makedirs(out.parent)
    trv.main(["--cpu", "--config", cfg, "--synthetic", "5", "--kf-every",
              "2", "--save-kf", str(out), "--out-dir", str(tmp_path)])
    st = tkf.load_keyframes(str(out), device="cpu")
    assert int(st.count) == 2 and st.capacity == 4
    assert not (tmp_path / "kf_list.npz").exists()


def _jax_store(path):
    return _np(jkf.load_keyframes(path))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(field_radius=2, window=3, mutual_px=1.5, landmark_stride=2),
    dict(revisit_dist=10.0, revisit_min_gap=2)])
def test_problem_from_keyframes_matches_jax(kf_runs, kw):
    """The JAX run's store (poses nudged so the transport is not the
    identity) through both packages' problem_from_keyframes: equal masks
    and ids, float fields within 1e-4 px."""
    p = kf_runs["params"]
    store = _jax_store(kf_runs["jax"])
    cam = dict(width=p.ImageWidth, height=p.ImageHeight, cx=p.PPx, cy=p.PPy)
    a = jba.problem_from_keyframes(
        jax.tree_util.tree_map(jnp.asarray, store), KF_ZF, **cam, **kw)
    b = tba.problem_from_keyframes(
        keyframe_store_from_numpy(store, device="cpu"), KF_ZF, **cam, **kw)
    for name, x, y in zip(jba.BAProblem._fields, a, b):
        x = np.asarray(x)
        assert y.shape == x.shape, name
        if x.dtype.kind in "bi":
            assert np.array_equal(x, y.numpy()), name
        else:
            np.testing.assert_allclose(y.numpy(), x, rtol=1e-5, atol=1e-4,
                                       err_msg=name)
    assert int(b.ovalid.sum()) > 100


def test_problem_from_keyframes_revisit_pairs_match_jax():
    """The revisit loop of both packages on tests/test_backend.py's
    4-keyframe store (window 1, every pair within reach, gap 2): it adds
    (0, 2) but never a pair ending in keyframe F-1 = 3, the JAX loop's
    quirk the port keeps (ROADMAP queue 3)."""
    store, cam = synthetic_kf_store()
    kw = dict(width=cam.width, height=cam.height, cx=float(cam.cx),
              cy=float(cam.cy), window=1, revisit_dist=1e3,
              revisit_min_gap=2)
    jp = jba.problem_from_keyframes(store, cam.zfm, **kw)
    tp = tba.problem_from_keyframes(
        keyframe_store_from_numpy(_np(store), device="cpu"), cam.zfm, **kw)
    for name, x, y in zip(jba.BAProblem._fields, jp, tp):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    K = store.klm.x.shape[1]
    pairs = sorted(set(zip((tp.obs_lm // K).tolist(), tp.obs_kf.tolist())))
    assert pairs == [(0, 1), (0, 2), (1, 2), (2, 3)]


def test_problem_from_keyframes_solve_matches_jax():
    """tests/test_backend.py's consistent synthetic store, poses perturbed:
    the same problem, the same first cost and floor, poses equal up to the
    gauge (measured 2.4e-7 of the extent), and the port pulls them back
    as that test asks. At the floor the costs are the matches' own
    residual, so they agree within 1e-5 of the first cost."""
    store, cam = synthetic_kf_store()
    kw = dict(width=cam.width, height=cam.height, cx=float(cam.cx),
              cy=float(cam.cy))
    jp = jba.problem_from_keyframes(store, cam.zfm, **kw)
    tp = tba.problem_from_keyframes(
        keyframe_store_from_numpy(_np(store), device="cpu"), cam.zfm, **kw)
    for name, x, y in zip(jba.BAProblem._fields, jp, tp):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    from rebvo_tpu.core.geometry import so3_exp
    rng = np.random.RandomState(7)
    R0, p0 = [np.asarray(store.Pose[0])], [np.asarray(store.Pos[0])]
    for f in range(1, store.capacity):
        R0.append(np.asarray(so3_exp(jnp.asarray(
            rng.randn(3) * 0.004, jnp.float32))) @ np.asarray(store.Pose[f]))
        p0.append(np.asarray(store.Pos[f]) + rng.randn(3) * 0.01)
    R0 = np.stack(R0).astype(np.float32)
    p0 = np.stack(p0).astype(np.float32)
    _, pj, _, cj = jba.ba_solve(jnp.asarray(R0), jnp.asarray(p0), jp,
                                jnp.asarray(cam.zfm, jnp.float32), iters=8)
    _, pt, _, ct = tba.ba_solve(torch.as_tensor(R0), torch.as_tensor(p0), tp,
                                float(cam.zfm), iters=8)
    c0 = float(cj[0])
    np.testing.assert_allclose(ct[0].item(), c0, rtol=1e-5)
    # the floor is the matches' own residual, 1e-6 of the first cost
    assert abs(ct[-1].item() - float(cj[-1])) < 1e-5 * c0
    assert ct[-1].item() < 0.1 * ct[0].item()
    true = np.asarray(store.Pos)
    ext = np.ptp(true, axis=0).max()
    assert ate_rmse(pt.numpy(), np.asarray(pj)) < 1e-5 * ext
    assert ate_rmse(pt.numpy(), true) < 0.6 * ate_rmse(p0, true)


def test_run_ba_matches_jax(tmp_path, capsys):
    """run_ba of both packages on tests/test_backend.py's perturbed
    synthetic store (--cpu --iters 8, 4 rounds): the same JSON keys,
    keyframe and landmark counts and first cost, the JAX test's bar (the
    optimized keyframes closer to the truth), positions within 0.5% of
    the extent up to the gauge (measured 0.12%: each of the 4 rounds
    re-matches from its solve's poses, whose gauge float32 roundoff
    moves), and a TUM file with a row per keyframe."""
    import json

    from rebvo_tpu.apps import run_ba as jrb
    from rebvo_tpu.core.geometry import so3_exp
    from rebvo_tpu_torch.apps import run_ba as trb
    store, _ = synthetic_kf_store()
    rng = np.random.RandomState(11)
    F = store.capacity
    R0, p0 = [np.asarray(store.Pose[0])], [np.asarray(store.Pos[0])]
    for f in range(1, F):
        R0.append(np.asarray(so3_exp(jnp.asarray(
            rng.randn(3) * 0.003, jnp.float32))) @ np.asarray(store.Pose[f]))
        p0.append(np.asarray(store.Pos[f]) + rng.randn(3) * 0.008)
    noisy = store._replace(Pose=jnp.asarray(np.stack(R0), jnp.float32),
                           Pos=jnp.asarray(np.stack(p0), jnp.float32))
    src = str(tmp_path / "kf_list.npz")
    jkf.save_keyframes(src, noisy)

    out, line = {}, {}
    for mod, tag in ((jrb, "j"), (trb, "t")):
        capsys.readouterr()
        rc = mod.main([src, "--out", str(tmp_path / f"{tag}.npz"),
                       "--trajectory", str(tmp_path / f"{tag}.tum"),
                       "--cpu", "--iters", "8"])
        assert rc == 0
        line[tag] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
        out[tag] = np.load(str(tmp_path / f"{tag}.npz"))["Pos"]
    assert sorted(line["t"]) == sorted(line["j"])
    for k in ("keyframes", "landmarks", "shards"):
        assert line["t"][k] == line["j"][k], k
    assert line["t"]["keyframes"] == F
    np.testing.assert_allclose(line["t"]["cost_initial"],
                               line["j"]["cost_initial"], rtol=1e-5)
    assert line["t"]["cost_final"] <= line["t"]["cost_initial"]
    true = np.asarray(store.Pos)
    ate0 = ate_rmse(np.asarray(noisy.Pos), true)
    assert ate_rmse(out["t"], true) < ate0
    ext = np.ptp(true, axis=0).max()
    assert ate_rmse(out["t"], out["j"]) < 5e-3 * ext
    rows = (tmp_path / "t.tum").read_text().strip().splitlines()
    assert len(rows) == F


def test_run_ba_refuses_shards(tmp_path):
    """--shards N > 1 names the ROADMAP item that ports it."""
    from rebvo_tpu_torch.apps import run_ba as trb
    with pytest.raises(SystemExit) as e:
        trb.main([str(tmp_path / "none.npz"), "--shards", "2", "--cpu"])
    assert e.value.code == 2
