"""The port's batched multi-sequence path on the CPU: K1's custom op and
its vmap rule, the step's scatter sites rewritten out of place, the
vmapped step against single lanes (bit for bit) and against the JAX
package's jax.vmap(step_fn), parallel/mesh, run_batch, the entry points
and the bench's batched phase. Small shapes: 188x120 and 96x64, B <= 4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rebvo_tpu.config import REBVOParameters as JaxParams
from rebvo_tpu.frontend.step import VOFrontend as JaxFrontend
from rebvo_tpu.io.render import render_plane_seq
from rebvo_tpu_torch import bench
from rebvo_tpu_torch.config import REBVOParameters, save_config
from rebvo_tpu_torch.convert import params_from_jax, state_from_numpy
from rebvo_tpu_torch.frontend.step import VOFrontend, tree_leaves
from rebvo_tpu_torch.kernels import cuda_scale_space as cs
from rebvo_tpu_torch.kernels.depth_filter import estimate_quantile
from rebvo_tpu_torch.kernels.edge_detect import (compact_keylines,
                                                 re_estimate_thresh)
from rebvo_tpu_torch.kernels.field import build_field
from rebvo_tpu_torch.kernels.matching import forward_match
from rebvo_tpu_torch.frontend.kf_tracking import invert_matches
from rebvo_tpu_torch.parallel.mesh import (data_mesh, gather, replicate,
                                           shard_batch, shard_sequences,
                                           stack_lanes)

torch.set_num_threads(2)

TINY = dict(width=188, height=120, zf=100.0, cx=94.0, cy=60.0, z0=3.0)
TILT = (0.35, 0.25, 1.0)
B, N_STEPS = 3, 3
K1_KW = dict(sigma0=1.0, k_sigma=1.6, win_s=2, per_hist=0.4,
             dog_thresh=0.0, max_img_value=765.0)


def tiny_params(cls=REBVOParameters, **kw):
    return cls().replace(
        ImageWidth=TINY["width"], ImageHeight=TINY["height"],
        ZfX=TINY["zf"], ZfY=TINY["zf"], PPx=TINY["cx"], PPy=TINY["cy"],
        KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0, KeylineMax=2048,
        MaxPoints=2048, ReferencePoints=800, TrackPoints=2048,
        GlobalMatchThreshold=50, DetectorThresh=0.03,
        DetectorAutoGain=1e-6, NavLogCap=16, **kw)


@pytest.fixture(scope="module")
def lanes():
    """B rendered tilted-plane sequences, each with its own speed and
    texture seed: [B, N_STEPS + 1, H, W] float32."""
    out = []
    for b in range(B):
        pos = np.zeros((N_STEPS + 1, 3))
        pos[:, 0] = np.arange(N_STEPS + 1) * (0.02 + 0.005 * b)
        out.append(render_plane_seq(N_STEPS + 1, cam_positions=pos,
                                    plane_normal=TILT, seed=b, **TINY))
    return np.stack(out).astype(np.float32)


def assert_trees_equal(a, b, lane=None):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        y = y if lane is None else y[lane]
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# K1 as a custom op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["frame_and_thresh", "shared_thresh",
                                  "pair_per_lane"])
def test_detect_op_vmap_matches_plain_per_frame(lanes, monkeypatch, case):
    """detect_candidates_cuda under vmap runs its plain version once over
    all the lanes' frames ([B, ..., H, W], one threshold per frame) and
    gives each lane exactly what the lane alone gives."""
    calls = []
    plain = cs.detect_candidates_plain

    def counted(img, *a, **kw):
        calls.append(tuple(img.shape))
        return plain(img, *a, **kw)
    monkeypatch.setattr(cs, "detect_candidates_plain", counted)
    imgs = torch.as_tensor(lanes[:, 0])
    th = torch.tensor([0.02, 0.03, 0.05])
    if case == "frame_and_thresh":
        out = torch.func.vmap(lambda i, t: tuple(cs.detect_candidates_cuda(
            i, t, **K1_KW)))(imgs, th)
        refs = [plain(imgs[b], th[b], **K1_KW) for b in range(B)]
    elif case == "shared_thresh":
        out = torch.func.vmap(lambda i: tuple(cs.detect_candidates_cuda(
            i, th[1], **K1_KW)))(imgs)
        refs = [plain(imgs[b], th[1], **K1_KW) for b in range(B)]
    else:
        pairs = torch.as_tensor(lanes[:, :2])          # [B, 2, H, W]
        out = torch.func.vmap(lambda i, t: tuple(cs.detect_candidates_cuda(
            i, t, **K1_KW)))(pairs, th)
        refs = [plain(pairs[b], th[b], **K1_KW) for b in range(B)]
        assert calls[0] == (B, 2) + imgs.shape[1:]
    assert len(calls) == 1 and calls[0][0] == B
    assert cs.detect_candidates_cuda.launches == 0     # the CPU launches
    for b in range(B):                                 # nothing
        for x, y in zip(out, refs[b]):
            torch.testing.assert_close(x[b], y, rtol=0, atol=0,
                                       equal_nan=True)


def test_detect_op_fake_shapes():
    """The op's fake implementation: a bool mask and five float32 maps of
    the frame's shape, with no data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        img = torch.empty(2, 48, 64)
        out = cs._detect_op(img, torch.empty(2), 1.0, 1.6, 3, 2, 0.4, 0.0,
                            765.0)
    assert [tuple(o.shape) for o in out] == [(2, 48, 64)] * 6
    assert [o.dtype for o in out] == [torch.bool] + [torch.float32] * 5


# ---------------------------------------------------------------------------
# the scatter sites, out of place
# ---------------------------------------------------------------------------


def _in_place(monkeypatch):
    """Route Tensor.scatter / scatter_reduce / scatter_add / index_put_
    through the in-place forms on a copy: the sites' old code."""
    for name in ("scatter", "scatter_reduce", "scatter_add"):
        inplace = getattr(torch.Tensor, name + "_")
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _f=inplace, **k:
                            _f(self.clone(), *a, **k))


def _site_inputs(lanes):
    """Each rewritten site's function and its arguments, from a state
    after bootstrap + one step of lane 0."""
    p = tiny_params()
    fe = VOFrontend(p, device="cpu")
    st0 = fe.bootstrap(fe.init(), lanes[0, 0], 0.0)
    st, out = fe.step(st0, lanes[0, 1], 0.05)
    cand = cs.detect_candidates_plain(torch.as_tensor(lanes[0, 2]),
                                      st.thresh, **K1_KW)
    mres_ids = st.klm.m_id
    return {
        "compact_keylines": lambda: compact_keylines(
            cand, K=p.KeylineMax, kl_max=p.MaxPoints, cx=94.0, cy=60.0),
        "build_field": lambda: build_field(st.klm, st.retuned, radius=4,
                                           height=120, width=188),
        "forward_match": lambda: forward_match(st0.klm, st.klm,
                                               torch.clamp(mres_ids, max=
                                                           p.KeylineMax - 1)),
        "invert_matches": lambda: invert_matches(st.klm.m_id, st.klm.valid,
                                                 p.KeylineMax),
        "re_estimate_thresh": lambda: re_estimate_thresh(st.klm, 800, 100),
        "estimate_quantile": lambda: estimate_quantile(st.klm),
    }


@pytest.mark.parametrize("site", ["compact_keylines", "build_field",
                                  "forward_match", "invert_matches",
                                  "re_estimate_thresh",
                                  "estimate_quantile"])
def test_scatter_sites_match_in_place(lanes, monkeypatch, site):
    """Each function whose scatter now runs out of place gives, bit for
    bit, what the in-place scatter gives on the same inputs."""
    fn = _site_inputs(lanes)[site]
    new = fn()
    _in_place(monkeypatch)
    old = fn()
    for x, y in zip(tree_leaves(new if isinstance(new, tuple) else (new,)),
                    tree_leaves(old if isinstance(old, tuple) else (old,))):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_nav_ring_append_in_place_matches_copy(lanes):
    """The donated step's ring append (index_put_, in place) writes the
    row the pure step's copy gets."""
    p = tiny_params()
    fe = VOFrontend(p, device="cpu")
    st = fe.bootstrap(fe.init(), lanes[0, 0], 0.0)
    pure_st, pure_out = fe.step(st, lanes[0, 1], 0.05)
    don_st, don_out = fe.step_donated(st, lanes[0, 1], 0.05)
    assert don_st.navlog is st.navlog                 # written in place
    assert_trees_equal(pure_st, don_st)


# ---------------------------------------------------------------------------
# the vmapped step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("donate", [False, True])
def test_vmap_step_matches_single_lanes(lanes, donate):
    """vmap(step) over B lanes: every leaf of every lane's state and
    output equal, bit for bit, to that lane stepped alone, and K1's plain
    version run once per batched call."""
    p = tiny_params()
    fe = VOFrontend(p, device="cpu")
    step = fe.step_donated if donate else fe.step
    sts = torch.func.vmap(fe.bootstrap)(
        stack_lanes(fe.init(), B), torch.as_tensor(lanes[:, 0]),
        torch.zeros(B))
    single = [fe.bootstrap(fe.init(), lanes[b, 0], 0.0) for b in range(B)]
    for i in range(1, N_STEPS + 1):
        sts, outs = torch.func.vmap(step)(sts, torch.as_tensor(lanes[:, i]),
                                         torch.full((B,), 0.05 * i))
        for b in range(B):
            single[b], out = step(single[b], lanes[b, i],
                                  torch.tensor(0.05 * i))
            assert_trees_equal(single[b], sts, lane=b)
            assert_trees_equal(out, outs, lane=b)
    assert int(outs.nav.kl_num.min()) > 500


def test_shard_sequences_matches_jax_vmap(lanes):
    """shard_sequences over B lanes (one CPU block) against the JAX
    package's jax.vmap(fe.step_fn), both from JAX's batched bootstrap
    state carried over by convert.state_from_numpy; the fused detector
    on both sides (JAX's Pallas kernel in the interpreter). Per lane and
    frame: kl_num equal, Pos within tests/test_torch_step.py's 1e-3."""
    jp = tiny_params(JaxParams)
    jfe = JaxFrontend(jp)
    jfe.use_pallas = True
    init = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape).copy(), jfe.init())
    with pltpu.force_tpu_interpret_mode():
        jst = jax.vmap(jfe.bootstrap_fn)(init, jnp.asarray(lanes[:, 0]),
                                         jnp.zeros((B,), jnp.float32))
        tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst),
                               device="cpu")
        stepj = jax.jit(jax.vmap(jfe.step_fn))
        jouts = []
        for i in range(1, N_STEPS + 1):
            jst, o = stepj(jst, jnp.asarray(lanes[:, i]),
                           jnp.full((B,), 0.05 * i, jnp.float32))
            jouts.append(o)
    fe = VOFrontend(params_from_jax(jp), device="cpu")
    mesh = data_mesh(1, backend="cpu")
    stepv = shard_sequences(fe.step_donated, mesh)
    tst = shard_batch(tst, mesh)
    for i, jo in enumerate(jouts, 1):
        tst, to = stepv(tst, shard_batch(torch.as_tensor(lanes[:, i]), mesh),
                        shard_batch(torch.full((B,), 0.05 * i), mesh))
        to = gather(to)
        np.testing.assert_array_equal(np.asarray(jo.nav.kl_num),
                                      to.nav.kl_num.numpy())
        np.testing.assert_allclose(np.asarray(jo.nav.Pos),
                                   to.nav.Pos.numpy(), atol=1e-3,
                                   err_msg=str(i))


# ---------------------------------------------------------------------------
# parallel/mesh, run_batch, entry, the bench
# ---------------------------------------------------------------------------


def test_data_mesh_refuses_missing_cuda_devices(capsys):
    """More CUDA devices than visible raises; allow_cpu_fallback gives
    CPU shards and says so."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="CUDA devices"):
        data_mesh(n)
    mesh = data_mesh(n, allow_cpu_fallback=True)
    assert mesh == [torch.device("cpu")] * n
    assert "falling back" in capsys.readouterr().out
    assert data_mesh(3, backend="cpu") == [torch.device("cpu")] * 3


def test_shard_batch_and_gather_round_trip():
    """shard_batch splits every leaf's leading axis into equal blocks,
    gather joins them back, replicate copies the tree to every device; an
    uneven batch is refused."""
    tree = (torch.arange(12.0).reshape(6, 2), torch.arange(6))
    blocks = shard_batch(tree, data_mesh(3, backend="cpu"))
    assert [b[0].shape[0] for b in blocks] == [2, 2, 2]
    back = gather(blocks)
    assert torch.equal(back[0], tree[0]) and torch.equal(back[1], tree[1])
    copies = replicate(tree, data_mesh(2, backend="cpu"))
    assert len(copies) == 2 and all(torch.equal(c[0], tree[0])
                                    for c in copies)
    with pytest.raises(ValueError, match="evenly"):
        shard_batch(tree, data_mesh(4, backend="cpu"))


def test_run_batch_writes_one_tum_per_sequence(tmp_path, capsys):
    """run_batch --synthetic 4 --batch 4 --cpu (the port's twin of
    tests/test_system.py::test_run_batch_synthetic) at 188x120: four TUM
    files of 3 poses each, and the JSON line."""
    from rebvo_tpu_torch.apps import run_batch
    cfg = str(tmp_path / "small.cfg")
    save_config(tiny_params(), cfg)
    out = str(tmp_path / "b")
    run_batch.main(["--synthetic", "4", "--batch", "4", "--cpu",
                    "--config", cfg, "--out-dir", out])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["sequences"] == 4 and line["frames_each"] == 4
    assert line["devices"] == 1 and line["aggregate_fps"] > 0
    trays = sorted(f for f in os.listdir(out) if f.startswith("tray_seq"))
    assert trays == [f"tray_seq{b}.txt" for b in range(4)]
    for f in trays:
        rows = np.loadtxt(os.path.join(out, f))
        assert rows.shape == (3, 8) and np.all(np.isfinite(rows))


def test_dryrun_multichip_on_cpu_shards():
    """entry.dryrun_multichip(4): four tiny sequences on four CPU shards
    (no CUDA device here), one batched step, finite positions."""
    from rebvo_tpu_torch import entry
    pos = entry.dryrun_multichip(4)
    assert pos.shape == (4, 3) and np.all(np.isfinite(pos))


def test_bench_phase_batched_on_cpu():
    """The bench's batched phase at 96x64 with 2 lanes and 2 steps: both
    rates positive, the keyframe tracking's share computed from them."""
    p = REBVOParameters().replace(
        ImageWidth=96, ImageHeight=64, PPx=48.0, PPy=32.0, ZfX=80.0,
        ZfY=80.0, KeylineMax=512, MaxPoints=512, TrackPoints=512,
        ReferencePoints=300, NavLogCap=64)
    out = bench.phase_batched(p, "cpu", bench.rendered_lanes(p, 3, 2),
                              n_iter=2)
    assert out["batch"] == 2
    assert out["batched_fps"] > 0 and out["batched_fps_nokf"] > 0
    np.testing.assert_allclose(
        out["kf_tracking_overhead_pct"],
        100.0 * (out["batched_fps_nokf"] - out["batched_fps"]) /
        out["batched_fps"])
