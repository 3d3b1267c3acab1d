"""The launch plan of the scale-space kernels' tile pipeline
(`kernels/cuda_scale_space.launch_plan`), a pure function the CUDA
wrappers call and whose plan and grid the C launchers take: which
instantiation runs a plan, its halo, radii, tile and grid, and the plans
it refuses. With the kernels' source built for the host
(`tests/tile_host.py`): the reciprocal tables the kernels build for a
plan, which must equal the plain versions' `_inv_count` bit for bit, and
the launchers' block and shared memory."""

import ctypes

import numpy as np
import pytest

from rebvo_tpu_torch.kernels import cuda_scale_space as cs
from rebvo_tpu_torch.kernels.scale_space import scale_space_plan

import tile_host

needs_gxx = pytest.mark.skipif(
    tile_host.compiler() is None,
    reason="the host build of the CUDA kernels needs g++")

K1, K2 = "detect_candidates", "build_scale_space"
KSIGMA = 1.2599
WIN_S = 2


def _plan(kernel, sigma0, shape=(480, 752), batch=1, box_n=3):
    s0, s1, _, _ = scale_space_plan(sigma0, KSIGMA, box_n)
    return cs.launch_plan(kernel, batch, *shape, s0, s1,
                          WIN_S if kernel == K1 else 0)


@pytest.mark.parametrize("kernel,halo", [(K1, 7), (K2, 5)])
def test_default_plan_takes_the_fixed_instantiation(kernel, halo):
    p = _plan(kernel, 1.7818)
    assert p.fixed
    assert p.halo == halo
    assert p.tile == (30, 48)
    assert p.grid == (16, 16, 1)           # 752 / 48 -> 16, 480 / 30 = 16
    assert p.radii == ((1, 1, 2), (1, 2, 2))
    assert p.margins == ((2, 2) if kernel == K1 else (1, 0))


@pytest.mark.parametrize("kernel,sigma0,halo", [
    (K1, 1.2, 5), (K1, 1.4, 6), (K2, 1.2, 3), (K2, 2.4, 8)])
def test_other_plans_take_the_runtime_instantiation(kernel, sigma0, halo):
    p = _plan(kernel, sigma0)
    assert not p.fixed
    assert p.halo == halo


def test_size_one_boxes_are_skipped():
    p = _plan(K1, 1.2)                     # sizes0 = [1, 3, 3]
    assert p.radii[0] == (1, 1)
    assert p.radii[1] == (1, 1, 1)


def test_k1_halo_without_plane_fit_window():
    """With win_s = 0 the DoG is needed on the tile only and img0 one pixel
    past it (the gradient): sigma0 = 2.4 (radii 6 and 8) runs at halo 8."""
    s0, s1, _, _ = scale_space_plan(2.4, KSIGMA, 3)
    p = cs.launch_plan(K1, 1, 480, 752, s0, s1, 0)
    assert p.margins == (1, 0)
    assert p.halo == 8
    assert not p.fixed


def test_halo_helpers_agree_with_the_plan():
    for sigma0 in (1.2, 1.4, 1.7818, 2.0):
        s0, s1, _, _ = scale_space_plan(sigma0, KSIGMA, 3)
        assert cs.detect_halo(s0, s1, WIN_S) == _plan(K1, sigma0).halo
        assert cs.sspace_halo(s0, s1) == _plan(K2, sigma0).halo


@pytest.mark.parametrize("kernel,sigma0", [(K1, 2.2), (K1, 3.56),
                                           (K2, 3.0), (K2, 3.56)])
def test_plan_beyond_max_halo_raises(kernel, sigma0):
    with pytest.raises(ValueError, match="halo"):
        _plan(kernel, sigma0)


@pytest.mark.parametrize("kernel", [K1, K2])
def test_plan_beyond_max_boxes_raises(kernel):
    with pytest.raises(ValueError, match="boxes"):
        _plan(kernel, 1.2, box_n=cs.MAX_BOXES + 1)


@pytest.mark.parametrize("shape,batch", [((480, 752), 4), ((481, 753), 1),
                                         ((9, 13), 2), ((57, 93), 1)])
def test_grid_covers_the_frame_once(shape, batch):
    p = _plan(K1, 1.7818, shape, batch)
    H, W = shape
    gx, gy, gz = p.grid
    assert gz == batch
    assert (gx - 1) * p.tile[1] < W <= gx * p.tile[1]
    assert (gy - 1) * p.tile[0] < H <= gy * p.tile[0]


@needs_gxx
def test_two_blocks_fit_one_sm():
    """The dynamic shared memory and threads each launcher passes: two
    blocks per SM fit the H100's 228 KB (1 KB reserved a block) and 2048
    threads, and a block has a thread per buffer column."""
    lib = tile_host.library()
    for kernel in (K1, K2):
        fn = getattr(lib, f"{kernel}_launch_config")
        smem, threads = ctypes.c_int(0), ctypes.c_int(0)
        fn(ctypes.byref(smem), ctypes.byref(threads))
        assert 2 * (smem.value + 1024) <= 228 * 1024
        assert 2 * threads.value <= 2048
        assert threads.value % (cs.TILE[1] + 2 * cs.MAX_HALO) == 0


@needs_gxx
@pytest.mark.parametrize("kernel,sigma0,shape", [
    (K1, 1.7818, (120, 188)), (K1, 1.2, (57, 93)), (K2, 2.4, (61, 100)),
    (K2, 1.7818, (9, 13))])
@pytest.mark.parametrize("axis", [0, 1])
def test_reciprocals_equal_inv_count(kernel, sigma0, shape, axis):
    """Every reciprocal the kernels' table code (`recip_entry`) gives a
    block for a pixel inside the image, row table and column table of each
    pass of each chain of the plan, equals `_inv_count` (1.0 / count in
    torch) at that pixel, bit for bit; a pass the plan lacks has none."""
    lib = tile_host.library()
    p = _plan(kernel, sigma0, shape)
    H, W = shape
    n = shape[axis]
    n_rows, br, nx, hp = (ctypes.c_int(0) for _ in range(4))
    max_boxes = lib.tile_table_shape(*map(ctypes.byref,
                                          (n_rows, br, nx, hp)))
    length = br.value if axis == 0 else nx.value
    table = np.empty(n_rows.value + 2 * max_boxes * nx.value, np.float32)
    r0, r1 = ((ctypes.c_int * len(r))(*r) for r in p.radii)
    args = (p.halo, p.win_s, *p.margins, r0, len(p.radii[0]), r1,
            len(p.radii[1]))
    for t in range(p.grid[1 - axis]):
        bx, by = (0, t) if axis == 0 else (t, 0)
        assert lib.tile_reciprocals(
            H, W, bx, by, *args,
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) == 0
        g = t * p.tile[axis] - hp.value + np.arange(length)
        inside = (g >= 0) & (g < n)
        for c, radii in enumerate(p.radii):
            for j in range(max_boxes):
                k = (c * max_boxes + j) * length + \
                    (0 if axis == 0 else n_rows.value)
                got = table[k:k + length]
                if j >= len(radii):
                    assert np.isnan(got).all()
                    continue
                ref = cs._inv_count(n, 2 * radii[j] + 1, "cpu").numpy()
                np.testing.assert_array_equal(
                    got[inside].view(np.uint32),
                    ref[g[inside]].view(np.uint32))

