"""The port's depth filler (kernels/depth_filler.py) and occupancy grid
(backend/surface.py) against the JAX package's on the CPU, on the same
seeded keylines (tests/test_depth_filler_stereo.py's tilted-plane scene,
at 752x480 with 8-pixel blocks: a 60x94 grid) and
tests/test_aux.py::test_ocgrid_and_raycut's wall.

Tolerances: `fixed` and the boundary masks exactly equal; rho and s_rho
within 2e-5 of each array's largest entry (FILL_REL). What differs is
roundoff: the seed's sums run in another order (the port accumulates in
float64 and rounds once), XLA's convolution and PyTorch's sum the 8
neighbours in other orders, and the relaxation contracts, so the
differences stay at a few float32 ulps of the largest entry (measured
below 1e-6 relative). Occupancy counts equal; visibility equal or within
a counted mismatch share of VIS_MISMATCH (measured 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebvo_tpu.backend import surface as jsurf
from rebvo_tpu.frontend.state import KeylineMap as JKeylineMap
from rebvo_tpu.kernels import depth_filler as jdf
from rebvo_tpu_torch.backend import surface as tsurf
from rebvo_tpu_torch.frontend.state import KeylineMap
from rebvo_tpu_torch.kernels import depth_filler as tdf

torch.set_num_threads(2)

W_IMG, H_IMG = 752, 480
ZFM, CX, CY = 400.0, 376.0, 240.0
FILL_REL = 2e-5
VIS_MISMATCH = 0.01


def plane_keylines(n, K=2048, seed=0, noise=0.0):
    """Keylines on a tilted plane (inverse depth linear in the image),
    tests/test_depth_filler_stereo.py's scene; `noise` adds a seeded
    perturbation to rho and spreads s_rho, so some cells see several
    keylines and some are gated by s_rho_max."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(40, 700, n).astype(np.float32)
    y = rng.uniform(40, 440, n).astype(np.float32)
    rho = (0.3 + 0.0004 * x + 0.0002 * y).astype(np.float32)
    s = np.full(n, 0.05, np.float32)
    if noise:
        rho = (rho + rng.normal(0, noise, n)).astype(np.float32)
        s = rng.uniform(0.01, 30.0, n).astype(np.float32)
    pad = lambda a, fill: np.concatenate([a, np.full(K - n, fill,
                                                     np.float32)])
    return dict(valid=np.arange(K) < n, x=pad(x, 0.0), y=pad(y, 0.0),
                rho=pad(rho, 1.0), s_rho=pad(s, 20.0))


def both(d):
    K = d["valid"].shape[0]
    jk = JKeylineMap.empty(K)._replace(
        **{k: jnp.asarray(v) for k, v in d.items()})
    tk = KeylineMap.empty(K, device="cpu")._replace(
        **{k: torch.as_tensor(v) for k, v in d.items()})
    return jk, tk


def assert_fill_close(jf, tf):
    np.testing.assert_array_equal(np.asarray(jf.fixed), tf.fixed.numpy())
    assert jf.block == tf.block
    for f in ("rho", "s_rho"):
        a, b = np.asarray(getattr(jf, f)), getattr(tf, f).numpy()
        assert a.shape == b.shape and np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=FILL_REL * np.abs(a).max(),
                                   err_msg=f)


@pytest.mark.parametrize("bound_mode", ["none", "corners", "full"])
@pytest.mark.parametrize("coarse_to_fine", [True, False])
def test_fill_depth_matches_jax(bound_mode, coarse_to_fine):
    """fill_depth on 120 sparse plane keylines and 800 noisy ones, in
    every boundary mode, with and without the coarse-to-fine start."""
    for d in (plane_keylines(120, seed=3),
              plane_keylines(800, seed=1, noise=0.02)):
        jk, tk = both(d)
        kw = dict(width=W_IMG, height=H_IMG, block=8, iters=60,
                  coarse_to_fine=coarse_to_fine, bound_mode=bound_mode)
        assert_fill_close(jdf.fill_depth(jk, **kw), tdf.fill_depth(tk, **kw))


@pytest.mark.parametrize("bound_mode", ["none", "corners", "full"])
def test_boundary_mask_equal(bound_mode):
    for gh, gw in ((60, 94), (3, 2), (1, 5)):
        np.testing.assert_array_equal(
            np.asarray(jdf._boundary_mask(gh, gw, bound_mode)),
            tdf._boundary_mask(gh, gw, bound_mode, "cpu").numpy())


def test_fill_depth_interpolates_plane():
    """tests/test_depth_filler_stereo.py's plane case on the port: the
    relaxed grid approximates the plane between the edges, and the grid
    points and normals match JAX's."""
    jk, tk = both(plane_keylines(800))
    kw = dict(width=W_IMG, height=H_IMG, block=8, iters=80)
    tf, jf = tdf.fill_depth(tk, **kw), jdf.fill_depth(jk, **kw)
    assert_fill_close(jf, tf)
    gh, gw = tf.rho.shape
    assert (gh, gw) == (60, 94)
    yy, xx = np.mgrid[0:gh, 0:gw]
    expect = 0.3 + 0.0004 * (xx + 0.5) * 8 + 0.0002 * (yy + 0.5) * 8
    err = np.abs(tf.rho.numpy()[4:-4, 4:-4] - expect[4:-4, 4:-4])
    assert np.median(err) < 0.02, np.median(err)

    tP = tdf.grid_points_3d(tf, ZFM, CX, CY).numpy()
    jP = np.asarray(jdf.grid_points_3d(jf, jnp.asarray(ZFM), jnp.asarray(CX),
                                       jnp.asarray(CY)))
    assert tP.shape == (gh, gw, 3)
    np.testing.assert_allclose(tP, jP, rtol=1e-5, atol=1e-6)
    tN = tdf.surface_normals(tf, torch.tensor(ZFM), CX, CY).numpy()
    jN = np.asarray(jdf.surface_normals(jf, jnp.asarray(ZFM),
                                        jnp.asarray(CX), jnp.asarray(CY)))
    np.testing.assert_allclose(tN, jN, atol=1e-4)
    nn = np.linalg.norm(tN[2:-2, 2:-2], axis=-1)
    assert np.all((nn > 0.99) & (nn < 1.01))


def _wall_scene():
    wall = np.stack(np.meshgrid(np.linspace(-1, 1, 21),
                                np.linspace(-1, 1, 21)), -1).reshape(-1, 2)
    wall3 = np.concatenate([wall, np.full((wall.shape[0], 1), 2.0)], -1)
    target = np.array([[0.0, 0.0, 4.0], [3.0, 0.0, 4.0]])
    return np.concatenate([wall3, target]).astype(np.float32), \
        target.astype(np.float32)


def test_ocgrid_and_raycut_match_jax():
    """tests/test_aux.py's wall: counts equal JAX's, the target behind
    the wall hidden and the one beside it clear, with and without a
    validity mask."""
    pts, target = _wall_scene()
    valid = np.ones(pts.shape[0], bool)
    valid[::7] = False
    jlo, jhi = jsurf.world_bounds(jnp.asarray(pts))
    tlo, thi = tsurf.world_bounds(torch.as_tensor(pts))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    for v in (np.ones_like(valid), valid):
        jg = jsurf.build_ocgrid(jnp.asarray(pts), jnp.asarray(v), jlo,
                                jnp.asarray(0.25), nx=32, ny=16, nz=32)
        tg = tsurf.build_ocgrid(torch.as_tensor(pts), torch.as_tensor(v),
                                tlo, 0.25, nx=32, ny=16, nz=32)
        np.testing.assert_array_equal(tg.count.numpy(),
                                      np.asarray(jg.count))
        assert tg.count.dtype == torch.int32
        assert int(tg.count.sum()) == int(v.sum())
    tg = tsurf.build_ocgrid(torch.as_tensor(pts),
                            torch.ones(pts.shape[0], dtype=torch.bool), tlo,
                            torch.tensor(0.25), nx=32, ny=16, nz=32)
    vis = tsurf.ray_cut_visibility(tg, torch.zeros(3),
                                   torch.as_tensor(target))
    assert vis.tolist() == [False, True]


def test_raycut_on_filled_grids_matches_jax():
    """Grids of dense fills, as phase 15 of chip_smoke.py builds them:
    the fills' world points (three surfaces, each 0.6 m right of and
    0.5 m nearer than the last) into one grid, then ray cuts from the
    origin to the farthest one's points, part of which the nearer ones
    hide. Counts equal; visibility equal or
    within VIS_MISMATCH of the points."""
    pts_t, pts_j = [], []
    for k in range(3):
        jk, tk = both(plane_keylines(400, seed=20 + k, noise=0.01))
        kw = dict(width=W_IMG, height=H_IMG, block=8, iters=40)
        off = np.asarray([0.6 * k, 0.0, -0.5 * k], np.float32)
        pts_t.append(tdf.grid_points_3d(tdf.fill_depth(tk, **kw), ZFM, CX,
                                        CY) + torch.as_tensor(off))
        pts_j.append(jdf.grid_points_3d(jdf.fill_depth(jk, **kw),
                                        jnp.asarray(ZFM), jnp.asarray(CX),
                                        jnp.asarray(CY)) + off)
    tP, jP = torch.stack(pts_t), jnp.stack(pts_j)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-4,
                               atol=1e-4)
    # one cloud for both grids (the port's), so the comparison is the
    # grid and the ray cut, not the fills' roundoff
    P = tP.numpy()
    lo, _ = tsurf.world_bounds(torch.as_tensor(P))
    dims = dict(nx=48, ny=32, nz=48)
    tg = tsurf.build_ocgrid(torch.as_tensor(P), torch.ones(P.shape[:-1],
                                                           dtype=torch.bool),
                            lo, 0.1, **dims)
    jg = jsurf.build_ocgrid(jnp.asarray(P), jnp.ones(P.shape[:-1], bool),
                            jnp.asarray(lo.numpy()), jnp.asarray(0.1), **dims)
    np.testing.assert_array_equal(tg.count.numpy(), np.asarray(jg.count))
    cam = np.zeros(3, np.float32)
    tv = tsurf.ray_cut_visibility(tg, torch.as_tensor(cam),
                                  torch.as_tensor(P[0])).numpy()
    jv = np.asarray(jsurf.ray_cut_visibility(jg, jnp.asarray(cam),
                                             jnp.asarray(P[0])))
    assert tv.shape == P.shape[1:-1]
    mismatch = float(np.mean(tv != jv))
    assert mismatch <= VIS_MISMATCH, mismatch
    assert 0 < tv.mean() < 1          # both outcomes occur
