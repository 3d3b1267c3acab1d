"""The parity harness and evaluation apps of the port
(rebvo_tpu_torch/apps/parity.py, apps/evaluate.py, apps/view_map.py)
against the JAX package's, on the CPU.

The scenes run at 376x240 (ZF 200): both harnesses take the camera from
module constants, patched alike in both modules. Rendered datasets must be
equal: the PNGs' pixels byte for byte (the JAX package encodes with PIL,
the port with its own io/png, so the compressed files differ), and the
frame lists, ground truth, IMU CSV and config text exactly. The ATE of a
row run by both packages' run_vo agrees within the tolerance PERF.md
states for the parity table: 25% of the JAX package's ATE or 5 mm,
whichever is larger.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from rebvo_tpu.apps import evaluate as jev
from rebvo_tpu.apps import parity as jpar
from rebvo_tpu_torch.apps import evaluate as tev
from rebvo_tpu_torch.apps import parity as tpar
from rebvo_tpu_torch.io.png import read_png

torch.set_num_threads(2)

SMALL = dict(W=376, H=240, ZF=200.0, CX=188.0, CY=120.0)
ATE_RTOL, ATE_ATOL = 0.25, 0.005


@pytest.fixture
def small_cam(monkeypatch):
    for mod in (jpar, tpar):
        for k, v in SMALL.items():
            monkeypatch.setattr(mod, k, v)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("kind", ["loop", "dolly_vi", "lateral_arc_dist",
                                  "loop_st"])
def test_render_dataset_matches_jax(tmp_path, small_cam, kind):
    """3 frames of each kind: the same files, the same pixels, the same
    frame lists, ground truth, IMU CSV and provenance."""
    n, seed = 3, tpar.seq_seed(kind)
    gj = jpar.render_dataset(str(tmp_path / "j"), kind, n, seed)
    gt = tpar.render_dataset(str(tmp_path / "t"), kind, n, seed)
    np.testing.assert_array_equal(gt, gj)
    fj, ft = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert fj == ft
    pngs = [f for f in ft if f.endswith(".png")]
    assert len(pngs) == n * (2 if kind.endswith("_st") else 1)
    for f in pngs:
        a = np.asarray(Image.open(tmp_path / "j" / f))
        b = read_png(str(tmp_path / "t" / f))
        assert a.dtype == b.dtype == np.uint8 and a.shape == (240, 376)
        assert a.tobytes() == b.tobytes(), f
        assert np.ptp(b) > 100
    for f in ft:
        if not f.endswith(".png"):
            assert (tmp_path / "j" / f).read_bytes() == \
                (tmp_path / "t" / f).read_bytes(), f


@pytest.mark.parametrize("flags", [dict(), dict(vi=True), dict(dist=True),
                                   dict(st=True)])
def test_parity_config_matches_jax(tmp_path, small_cam, flags):
    """The GlobalConfig both sides read, written by the port's own
    save_config, is the JAX package's text but for the header comment
    that names the package that wrote it."""
    def body(path):
        lines = open(path).read().splitlines()
        assert "generated by" in lines[0]
        return lines[1:]
    text_j = body(jpar.write_parity_config(str(tmp_path), **flags))
    assert body(tpar.write_parity_config(str(tmp_path), **flags)) == text_j
    assert len(text_j) > 100


@pytest.mark.parametrize("kind", ["lateral_arc", "dolly", "loop", "loop3"])
def test_paths_and_helpers_match_jax(tmp_path, kind):
    """The camera paths, their VI variant and IMU CSV, the stereo pair
    poses, _so3_log_np, _resample and _dataset_t0."""
    for n in (2, 37, 240):
        for x, y in zip(jpar._traj(kind, n), tpar._traj(kind, n)):
            np.testing.assert_array_equal(x, y)
    ts = np.linspace(-0.3, 12.5, 301)
    for x, y in zip(jpar._vi_pose_at(kind, ts, 11.95),
                    tpar._vi_pose_at(kind, ts, 11.95)):
        np.testing.assert_array_equal(x, y)
    pos, rot = tpar._traj(kind, 9)
    for x, y in zip(jpar._pair_poses(pos, rot), tpar._pair_poses(pos, rot)):
        np.testing.assert_array_equal(x, y)
    for R in rot:
        np.testing.assert_array_equal(jpar._so3_log_np(R),
                                      tpar._so3_log_np(R))
    a = jpar._write_imu_csv(str(tmp_path), kind, 12)
    text_j = open(a).read()
    assert open(tpar._write_imu_csv(str(tmp_path), kind, 12)).read() == \
        text_j
    P = np.random.RandomState(0).randn(237, 3)
    for n in (237, 240, 100):
        np.testing.assert_array_equal(jpar._resample(P, n),
                                      tpar._resample(P, n))
    (tmp_path / "data.csv").write_text("#t,f\n1000000000,000000.png\n")
    assert jpar._dataset_t0(str(tmp_path)) == \
        tpar._dataset_t0(str(tmp_path)) == 1.0
    assert tpar.seq_seed(kind) == {"lateral_arc": 7, "dolly": 20,
                                   "loop": 33, "loop3": 33}[kind]


def test_evaluate_sequence_matches_jax(tmp_path, small_cam, monkeypatch):
    """One mono `loop` row at 376x240 over 24 frames through both
    harnesses (--cpu, no reference): the port's ATE against the ground
    truth within max(25% of JAX's, 5 mm) of JAX's. The port's run also
    captures a keyframe every 4 frames and refines them with its run_ba
    (--ba-every), whose JSON line the harness parses."""
    monkeypatch.setenv("REBVO_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    n, seed = 24, tpar.seq_seed("loop")
    tdir, jdir = tmp_path / "t" / "loop", tmp_path / "j" / "loop"
    rt = tpar.evaluate_sequence(str(tdir), "loop", n, seed, skip_ref=True,
                                ba_every=4, cpu=True)
    # the same dataset (test_render_dataset_matches_jax), run by JAX's
    shutil.copytree(tdir, jdir, ignore=shutil.ignore_patterns("repo_out*"))
    rj = jpar.evaluate_sequence(str(jdir), "loop", n, seed, skip_ref=True,
                                reuse=True)
    for k in ("sequence", "n_frames", "seed", "mode", "ate_repo_vs_gt"):
        assert k in rt, k
    assert rt["mode"] == rj["mode"] == "mono"
    assert rt["repo_device"] == "cpu"
    assert np.isfinite(rt["ate_repo_vs_gt"])
    assert abs(rt["ate_repo_vs_gt"] - rj["ate_repo_vs_gt"]) <= max(
        ATE_RTOL * rj["ate_repo_vs_gt"], ATE_ATOL), (rt, rj)
    ba = rt["ba"]
    assert ba["keyframes"] >= 3 and ba["observations"] > 0
    assert ba["cost_final"] <= ba["cost_initial"]
    assert np.isfinite(ba["ate_kf_ba_vs_gt"])
    # CPU run: no kernel launched
    assert rt["repo_kernel_launches"] == {"detect_candidates_cuda": 0,
                                          "build_scale_space_cuda": 0,
                                          "minimizer_rv": 0,
                                          "minimizer_v": 0,
                                          "correct_and_augment": 0,
                                          "md_match": 0, "md_depth": 0}


def test_run_repo_without_cuda_fails(tmp_path, small_cam):
    """No fallback hides the card: run_repo without cpu=True on a machine
    without CUDA fails with run_vo's error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tpar.render_dataset(str(tmp_path), "loop", 2, 33)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.run_repo(str(tmp_path), timeout=300)


def _tum(path, t, p):
    q = np.tile([0.0, 0.0, 0.0, 1.0], (len(t), 1))
    with open(path, "w") as fh:
        for i in range(len(t)):
            fh.write(" ".join(f"{v:.9f}" for v in
                              [t[i], *p[i], *q[i]]) + "\n")


@pytest.mark.parametrize("euroc", [False, True])
def test_evaluate_app_matches_jax(tmp_path, capsys, euroc):
    """apps/evaluate of both packages on one trajectory pair: a scaled,
    noisy estimate against a TUM ground truth (Sim(3) alignment), and a
    shifted-clock estimate against a EuRoC CSV (--no-scale)."""
    rng = np.random.RandomState(5)
    t_gt = np.arange(200) * 0.005
    p_gt = np.cumsum(rng.randn(200, 3) * 0.01, axis=0)
    t_est = t_gt[::4] + rng.uniform(-0.002, 0.002, 50)
    p_est = 0.7 * p_gt[::4] + rng.randn(50, 3) * 0.002
    _tum(tmp_path / "est.txt", t_est, p_est)
    args = [str(tmp_path / "est.txt")]
    if euroc:
        with open(tmp_path / "gt.csv", "w") as fh:
            fh.write("#timestamp,p_x,p_y,p_z\n")
            for t, p in zip(t_gt, p_gt):
                fh.write(f"{int(round(t * 1e9))},{p[0]},{p[1]},{p[2]}\n")
        args += [str(tmp_path / "gt.csv"), "--euroc-gt", "--no-scale"]
        for x, y in zip(jev.read_euroc_gt(str(tmp_path / "gt.csv")),
                        tev.read_euroc_gt(str(tmp_path / "gt.csv"))):
            np.testing.assert_array_equal(x, y)
    else:
        _tum(tmp_path / "gt.txt", t_gt, p_gt)
        args += [str(tmp_path / "gt.txt")]
    for x, y in zip(jev.associate(t_est, t_gt), tev.associate(t_est, t_gt)):
        np.testing.assert_array_equal(x, y)
    rj = jev.main(args)
    capsys.readouterr()
    rt = tev.main(args)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        rt
    assert rt == rj and rt["pairs"] == 50


def test_view_map_draws_a_store(tmp_path):
    """view_map renders a keyframe store written by the port into a PNG."""
    from rebvo_tpu_torch.apps import view_map
    from rebvo_tpu_torch.backend.keyframe import (KeyframeStore,
                                                  push_keyframe,
                                                  save_keyframes)
    from rebvo_tpu_torch.frontend.state import KeylineMap
    rng = np.random.RandomState(2)
    store = KeyframeStore.empty(3, 64, device="cpu")
    for i in range(2):
        klm = KeylineMap.empty(64, device="cpu")._replace(
            valid=torch.ones(64, dtype=torch.bool),
            px=torch.as_tensor(rng.uniform(-200, 200, 64).astype(np.float32)),
            py=torch.as_tensor(rng.uniform(-100, 100, 64).astype(np.float32)),
            rho=torch.full((64,), 0.5), s_rho=torch.full((64,), 0.1))
        push_keyframe(store, klm, torch.tensor(float(i)), torch.tensor(1.0),
                      torch.eye(3), torch.tensor([0.1 * i, 0.0, 0.0]),
                      torch.zeros(3))
    save_keyframes(str(tmp_path / "kf.npz"), store)
    view_map.main([str(tmp_path / "kf.npz"), "--out",
                   str(tmp_path / "map.png")])
    w, h = Image.open(tmp_path / "map.png").size
    assert w > 100 and h > 100
