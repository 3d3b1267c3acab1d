"""The scale-space kernels K1 (fused detector) and K2 (scale space) of the
PyTorch port against the JAX package.

`detect_candidates_plain` and `build_scale_space_plain` (the CUDA
kernels' plain PyTorch versions, what the port runs on the CPU) are held
against the JAX Pallas kernels run by the Pallas interpreter and against
the JAX XLA chain. The interpreter's fused XLA program contracts some
multiply-adds that the port keeps separate, so the fields agree to f32
roundoff (about 1e-5 here) rather than bit for bit; the bars are the
ones tests/test_pallas.py sets between the Pallas kernels and XLA: for
K1 the mask exactly equal and the fields within 5e-3 at masked pixels,
for K2 all five maps within 5e-3.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebvo_tpu.kernels.edge_detect import compact_keylines as jax_compact
from rebvo_tpu.kernels.edge_detect import detect_candidates as jax_detect
from rebvo_tpu.kernels.edge_detect import detect_keylines as jax_keylines
from rebvo_tpu.kernels.pallas_scale_space import (build_scale_space_pallas,
                                                  detect_candidates_pallas)
from rebvo_tpu.kernels.scale_space import build_scale_space as jax_sspace
from rebvo_tpu_torch.kernels import cuda_scale_space as cs
from rebvo_tpu_torch.kernels import edge_detect as ted
from rebvo_tpu_torch.kernels import scale_space as tss

torch.set_num_threads(2)

DOG = 0.095259868922420
KW = dict(sigma0=1.7818, k_sigma=1.2599, win_s=2, per_hist=0.4,
          dog_thresh=DOG, max_img_value=765.0)
FIELDS = ("theta_x", "theta_y", "xs", "ys", "n2_m")
SS_FIELDS = ("img0", "img1", "dog", "dx", "dy")


def _frame(shape, seed):
    return np.random.default_rng(seed).uniform(0, 765, shape).astype(
        np.float32)


def _assert_candidates(ref, out, min_edges=100):
    """Mask exactly equal; fields within 5e-3 at masked pixels (the
    Pallas-vs-XLA bar of tests/test_pallas.py)."""
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(m, out.mask.numpy())
    assert m.sum() > min_edges
    for f in FIELDS:
        d = np.abs(np.where(m, np.asarray(getattr(ref, f))
                            - getattr(out, f).numpy(), 0.0)).max()
        assert d < 5e-3, (f, d)


@pytest.mark.parametrize("shape,seed", [((72, 96), 3), ((57, 93), 5),
                                        ((2, 40, 56), 1)])
def test_plain_matches_pallas_interpret(shape, seed):
    img = _frame(shape, seed)
    ref = detect_candidates_pallas(jnp.asarray(img), jnp.float32(0.03),
                                   interpret=True, **KW)
    out = cs.detect_candidates_plain(torch.as_tensor(img),
                                     torch.tensor(0.03), **KW)
    _assert_candidates(ref, out)


@pytest.mark.parametrize("shape,seed", [((72, 96), 3), ((57, 93), 5),
                                        ((2, 40, 56), 1)])
def test_plain_matches_xla_chain(shape, seed):
    img = _frame(shape, seed)
    ss = jax_sspace(jnp.asarray(img), 1.7818, 1.2599, 3)
    ref = jax_detect(ss, 2, 0.4, jnp.float32(0.03), DOG, 765.0)
    out = cs.detect_candidates_plain(torch.as_tensor(img),
                                     torch.tensor(0.03), **KW)
    _assert_candidates(ref, out)


def test_per_batch_threshold():
    """One threshold per leading batch index equals per-frame calls."""
    img = torch.as_tensor(_frame((2, 40, 56), 2))
    th = torch.tensor([0.02, 0.05])
    both = cs.detect_candidates_plain(img, th, **KW)
    for b in range(2):
        one = cs.detect_candidates_plain(img[b], th[b], **KW)
        assert torch.equal(both.mask[b], one.mask)
        assert torch.equal(both.n2_m[b], one.n2_m)


def test_wrapper_routes_cpu_to_plain_and_rejects_other_devices():
    img = torch.as_tensor(_frame((40, 56), 4))
    th = torch.tensor(0.03)
    n0 = cs.detect_candidates_cuda.launches
    a = cs.detect_candidates_cuda(img, th, **KW)
    b = cs.detect_candidates_plain(img, th, **KW)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert cs.detect_candidates_cuda.launches == n0   # no kernel launched
    with pytest.raises(ValueError):
        cs.detect_candidates_cuda(img.to("meta"), th, **KW)


def test_halo_from_plan():
    """The kernel's tile halo at the EuRoC sigmas: sizes1 radius 5 plus
    the 2-px plane-fit window."""
    s0, s1, _, _ = tss.scale_space_plan(1.7818, 1.2599, 3)
    assert (s0, s1) == ([3, 3, 5], [3, 5, 5])
    assert cs.detect_halo(s0, s1, 2) == 7


@pytest.mark.parametrize("K,kl_max", [(512, 512), (256, 200)])
def test_compact_keylines_matches_jax(K, kl_max):
    """Port compact_keylines over the plain K1 equals JAX compact_keylines
    over the Pallas kernel (the bar of test_pallas.py:69-91), including
    the raster-order truncation at K / kl_max."""
    img = _frame((64, 96), 4)
    cand_j = detect_candidates_pallas(jnp.asarray(img), jnp.float32(0.03),
                                      interpret=True, **KW)
    a_klm, a_mask, a_n = jax_compact(cand_j, K=K, kl_max=kl_max, cx=48.0,
                                     cy=32.0)
    cand_t = cs.detect_candidates_plain(torch.as_tensor(img),
                                        torch.tensor(0.03), **KW)
    b_klm, b_mask, b_n = ted.compact_keylines(cand_t, K=K, kl_max=kl_max,
                                              cx=48.0, cy=32.0)
    assert int(a_n) == int(b_n)
    np.testing.assert_array_equal(np.asarray(a_mask), b_mask.numpy())
    for f in ("valid", "n_id", "p_id", "m_id", "m_num"):
        np.testing.assert_array_equal(np.asarray(getattr(a_klm, f)),
                                      getattr(b_klm, f).numpy(), err_msg=f)
    for f in ("x", "y", "gx", "gy", "n_m", "px", "py"):
        np.testing.assert_allclose(np.asarray(getattr(a_klm, f)),
                                   getattr(b_klm, f).numpy(), atol=1e-3,
                                   err_msg=f)


@pytest.mark.parametrize("shape,sigma0", [((48, 64), 3.56), ((57, 93), 1.7818)])
def test_scale_space_twin_matches_jax(shape, sigma0):
    """The UsePallas=0 twin: prefix-sum box chains against JAX's, atol
    5e-3 (the two cumsums round in different orders)."""
    img = _frame(shape, 0)
    a = jax_sspace(jnp.asarray(img), sigma0, 1.2599, 3)
    b = tss.build_scale_space(torch.as_tensor(img), sigma0, 1.2599, 3)
    for f in SS_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   getattr(b, f).numpy(), atol=5e-3,
                                   err_msg=f)


def test_detect_keylines_twin_matches_jax():
    img = _frame((72, 96), 3)
    th = 0.03
    a = jax_keylines(jax_sspace(jnp.asarray(img), 1.7818, 1.2599, 3),
                     jnp.float32(th), K=1024, kl_max=1024, win_s=2,
                     per_hist=0.4, dog_thresh=DOG, max_img_value=765.0,
                     cx=48.0, cy=36.0)
    b = ted.detect_keylines(tss.build_scale_space(torch.as_tensor(img),
                                                  1.7818, 1.2599, 3),
                            torch.tensor(th), K=1024, kl_max=1024, win_s=2,
                            per_hist=0.4, dog_thresh=DOG,
                            max_img_value=765.0, cx=48.0, cy=36.0)
    assert int(a[2]) == int(b[2])
    np.testing.assert_array_equal(np.asarray(a[1]), b[1].numpy())
    np.testing.assert_array_equal(np.asarray(a[0].n_id), b[0].n_id.numpy())



# tests/test_pallas.py's scale-space cases: (shape, sigma0, rng seed)
SS_CASES = [((48, 64), 3.56, 0), ((57, 93), 3.56, 0), ((2, 40, 56), 1.7818, 1),
            ((48, 96), 1.7818, 2)]


def _assert_maps(ref, out):
    for f in SS_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(ref, f)),
                                   getattr(out, f).numpy(), atol=5e-3,
                                   err_msg=f)


@pytest.mark.parametrize("shape,sigma0,seed", SS_CASES)
def test_sspace_plain_matches_pallas_interpret(shape, sigma0, seed):
    """K2's plain version against build_scale_space_pallas, interpreted."""
    img = _frame(shape, seed)
    ref = build_scale_space_pallas(jnp.asarray(img), sigma0, 1.2599, 3,
                                   interpret=True)
    _assert_maps(ref, cs.build_scale_space_plain(torch.as_tensor(img),
                                                 sigma0, 1.2599, 3))


@pytest.mark.parametrize("shape,sigma0,seed", SS_CASES)
def test_sspace_plain_matches_xla(shape, sigma0, seed):
    """K2's plain version against the JAX XLA build_scale_space."""
    img = _frame(shape, seed)
    ref = jax_sspace(jnp.asarray(img), sigma0, 1.2599, 3)
    _assert_maps(ref, cs.build_scale_space_plain(torch.as_tensor(img),
                                                 sigma0, 1.2599, 3))


def test_sspace_wrapper_routes_cpu_to_plain_and_checks_input():
    img = torch.as_tensor(_frame((40, 56), 4))
    n0 = cs.build_scale_space_cuda.launches
    a = cs.build_scale_space_cuda(img, 1.7818, 1.2599)
    b = cs.build_scale_space_plain(img, 1.7818, 1.2599)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert cs.build_scale_space_cuda.launches == n0   # no kernel launched
    with pytest.raises(TypeError):
        cs.build_scale_space_cuda(img.double(), 1.7818, 1.2599)
    with pytest.raises(ValueError):
        cs.build_scale_space_cuda(img.t(), 1.7818, 1.2599)
    with pytest.raises(ValueError):
        cs.build_scale_space_cuda(img.to("meta"), 1.7818, 1.2599)


def test_sspace_halo_from_plan():
    """K2's tile halo at the EuRoC sigmas: the sizes1 chain's radius 5,
    and the sizes0 chain's radius 4 plus the gradient's pixel."""
    s0, s1, _, _ = tss.scale_space_plan(1.7818, 1.2599, 3)
    assert cs.sspace_halo(s0, s1) == 5


def test_detect_plain_unchanged_by_sspace_plain():
    """detect_candidates_plain builds its scale space with
    build_scale_space_plain; its output bytes are the ones of the version
    that built the chains inline (digest recorded from that version)."""
    img = _frame((2, 40, 56), 6)
    c = cs.detect_candidates_plain(torch.as_tensor(img),
                                   torch.tensor([0.02, 0.04]), **KW)
    h = hashlib.sha256()
    for t in c:
        h.update(t.contiguous().numpy().tobytes())
    assert int(c.mask.sum()) == 830
    assert h.hexdigest() == ("8d8af1fc013bc91d7f5f640b2e1008a2"
                             "dbfa9fe48fffe0462d02eb439cec408e")
