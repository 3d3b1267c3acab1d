"""The scale-space kernels' CUDA source, run on the CPU.

`tests/tile_host.py` builds `csrc/detect_candidates.cu` (K1) and
`csrc/build_scale_space.cu` (K2) with g++ under a host emulation of the
CUDA subset they use (one std::thread per CUDA thread, shared memory
filled with NaNs before every block), and launches them through the CUDA
wrappers' own launch path. Each kernel must give its plain PyTorch
version's floats bit for bit (mask equal, every map equal, NaNs in the
same places), at the default plans (the compile-time instantiations) and
at other plans (the run-time instantiation), on ragged shapes, batches and
a misaligned frame (the scalar load and store paths). The launchers must
refuse a plan or a grid that the kernels cannot run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rebvo_tpu_torch.kernels import cuda_scale_space as cs
from rebvo_tpu_torch.kernels.scale_space import scale_space_plan

import tile_host

pytestmark = pytest.mark.skipif(
    tile_host.compiler() is None,
    reason="the host build of the CUDA kernels needs g++")

torch.set_num_threads(2)

DOG = 0.095259868922420
KSIGMA = 1.2599
KW = dict(sigma0=1.7818, k_sigma=KSIGMA, win_s=2, per_hist=0.4,
          dog_thresh=DOG, max_img_value=765.0)
FIELDS = ("theta_x", "theta_y", "xs", "ys", "n2_m")
SS_FIELDS = ("img0", "img1", "dog", "dx", "dy")


def _frame(shape, seed, kind="uniform"):
    """A uniform random frame, or a blocky one (flat 7x7 patches: zero
    DoG regions and step edges)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, 765, shape).astype(np.float32)
    *lead, h, w = shape
    coarse = rng.uniform(0, 765, (*lead, -(-h // 7), -(-w // 7)))
    big = coarse.repeat(7, axis=-2).repeat(7, axis=-1)
    return np.ascontiguousarray(big[..., :h, :w], dtype=np.float32)


def _misaligned(img):
    """`img` as a tensor whose data starts 4 bytes past a 16-byte line."""
    flat = torch.empty(img.size + 1, dtype=torch.float32)
    t = flat[1:].view(img.shape)
    t.copy_(torch.as_tensor(img))
    assert t.data_ptr() % 16 != 0
    return t


def _assert_same_floats(a, b, what):
    a, b = a.numpy(), b.numpy()
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b), err_msg=what)
    np.testing.assert_array_equal(a[~nan].view(np.int32),
                                  b[~nan].view(np.int32), err_msg=what)


K1_CASES = [
    # (shape, seed, kind, sigma0, win_s, thresholds)
    ((120, 188), 0, "uniform", 1.7818, 2, (0.03, 0.08)),
    ((120, 188), 1, "blocky", 1.7818, 2, (0.03,)),
    ((57, 93), 2, "uniform", 1.7818, 2, (0.03,)),
    ((9, 13), 3, "uniform", 1.7818, 2, (0.03,)),
    ((2, 40, 56), 4, "uniform", 1.7818, 2, ((0.03, 0.08),)),
    ((61, 100), 5, "uniform", 1.2, 2, (0.03,)),
    ((61, 100), 6, "blocky", 1.4, 2, (0.03,)),
    ((57, 93), 7, "uniform", 1.4, 2, (0.03,)),
    ((40, 60), 8, "uniform", 2.4, 0, (0.03,)),
]


@pytest.mark.parametrize("shape,seed,kind,sigma0,win_s,ths", K1_CASES)
def test_k1_host_build_equals_plain(shape, seed, kind, sigma0, win_s, ths):
    img = torch.as_tensor(_frame(shape, seed, kind))
    kw = dict(KW, sigma0=sigma0, win_s=win_s)
    s0, s1, _, _ = scale_space_plan(sigma0, KSIGMA, 3)
    plan = cs.launch_plan("detect_candidates", 1, *shape[-2:], s0, s1, win_s)
    assert plan.fixed == (sigma0 == 1.7818 and win_s == 2)
    for th in ths:
        tht = torch.tensor(th, dtype=torch.float32)
        got = tile_host.detect(img, tht, **kw)
        ref = cs.detect_candidates_plain(img, tht, **kw)
        np.testing.assert_array_equal(got.mask.numpy(), ref.mask.numpy())
        if win_s > 0:
            assert ref.mask.sum() > 0
        for f in FIELDS:
            _assert_same_floats(getattr(got, f), getattr(ref, f), f)


def test_k1_host_build_misaligned_frame():
    """A frame not on a 16-byte line takes the scalar loads (W % 4 == 0
    still gives the vector stores)."""
    img = _misaligned(_frame((61, 100), 9))
    tht = torch.tensor(0.03, dtype=torch.float32)
    got = tile_host.detect(img, tht, **KW)
    ref = cs.detect_candidates_plain(img, tht, **KW)
    np.testing.assert_array_equal(got.mask.numpy(), ref.mask.numpy())
    for f in FIELDS:
        _assert_same_floats(getattr(got, f), getattr(ref, f), f)


K2_CASES = [
    ((120, 188), 0, "uniform", 1.7818),
    ((120, 188), 1, "blocky", 1.7818),
    ((57, 93), 2, "uniform", 1.7818),
    ((9, 13), 3, "uniform", 1.7818),
    ((2, 40, 56), 4, "uniform", 1.7818),
    ((61, 100), 5, "uniform", 1.2),
    ((57, 93), 6, "uniform", 2.4),
]


@pytest.mark.parametrize("shape,seed,kind,sigma0", K2_CASES)
def test_k2_host_build_equals_plain(shape, seed, kind, sigma0):
    img = torch.as_tensor(_frame(shape, seed, kind))
    got = tile_host.sspace(img, sigma0, KSIGMA)
    ref = cs.build_scale_space_plain(img, sigma0, KSIGMA)
    for f in SS_FIELDS:
        _assert_same_floats(getattr(got, f), getattr(ref, f), f)


def test_k2_host_build_misaligned_frame():
    img = _misaligned(_frame((61, 100), 9))
    got = tile_host.sspace(img, 1.7818, KSIGMA)
    ref = cs.build_scale_space_plain(img, 1.7818, KSIGMA)
    for f in SS_FIELDS:
        _assert_same_floats(getattr(got, f), getattr(ref, f), f)


def _bad_plans(plan):
    """Plans and grids a launcher must refuse, made from a good `plan`."""
    gx, gy, gz = plan.grid
    return {
        "grid_short": dataclasses.replace(plan, grid=(gx - 1, gy, gz)),
        "grid_long": dataclasses.replace(plan, grid=(gx, gy + 1, gz)),
        "halo_short": dataclasses.replace(plan, halo=plan.halo - 1),
        "fixed_other_plan": dataclasses.replace(
            plan, fixed=True, radii=(plan.radii[0], plan.radii[1][:-1])),
        "too_many_boxes": dataclasses.replace(
            plan, radii=(plan.radii[0] + (1, 1), plan.radii[1])),
        "no_gradient_margin": dataclasses.replace(
            plan, margins=(0, plan.margins[1])),
    }


@pytest.mark.parametrize("kernel", ["detect_candidates", "build_scale_space"])
def test_launchers_refuse_what_the_kernels_cannot_run(kernel):
    lib = tile_host.library()
    H, W = 61, 100
    s0, s1, _, _ = scale_space_plan(1.7818, KSIGMA, 3)
    k1 = kernel == "detect_candidates"
    plan = cs.launch_plan(kernel, 1, H, W, s0, s1, 2 if k1 else 0)
    img = torch.as_tensor(_frame((H, W), 0))
    outs = [torch.empty((H, W)) for _ in range(5)]
    ptrs = [o.data_ptr() for o in outs]

    def launch(p):
        if k1:
            th = torch.tensor([0.03], dtype=torch.float32)
            mask = torch.empty((H, W), dtype=torch.bool)
            return lib.detect_candidates_launch(
                img.data_ptr(), th.data_ptr(), mask.data_ptr(), *ptrs, 1, H,
                W, *p.c_args(), 10.0, 765.0, DOG, 50.0, 25.0, None)
        return lib.build_scale_space_launch(img.data_ptr(), *ptrs, 1, H, W,
                                            *p.c_args(), None)
    assert launch(plan) == 0
    for name, bad in _bad_plans(plan).items():
        assert launch(bad) != 0, name
