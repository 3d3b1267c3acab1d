"""Per-stage time breakdown and roofline accounting for the VO step on a
CUDA card (PyTorch counterpart of rebvo_tpu/profiling.py).

`stage_breakdown` times each stage of the step on a realistic
mid-sequence state (taken after full steps, so gather and scatter
densities match a real run). `roofline` turns those times into
utilisation against explicit byte models, the JAX package's, stated
against the memory rate of one H100. `step_cost_analysis` counts the
step's matrix-product FLOPs.

Each stage is timed by the host clock around `n` calls after one warm
call, ending in `torch.cuda.synchronize()` on the card: in the eager
port a stage's time includes the host's launch path, which is what a
caller of that stage waits for.

Peaks of one H100 (NVIDIA's data sheet, SXM part, dense, at the full
700 W power limit): 3.35e12 bytes/s of HBM and 67e12 float32 FLOP/s
outside the tensor cores.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

H100_MEM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


def sync(device) -> None:
    """Wait for the card's queued work (CPU ops are synchronous)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(device, n, fn, *args, **kw):
    """(seconds per call, last result) of `fn(*args, **kw)`: one warm
    call, then the host clock around `n` calls that ends in a sync."""
    out = fn(*args, **kw)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    sync(device)
    return (time.perf_counter() - t0) / n, out


def stage_breakdown(fe, state, frame, n: int = 20) -> Dict[str, float]:
    """Per-stage times (ms) of one VO step's sub-stages, plus the whole
    step. `state` should be a mid-sequence state. Keys: `scale_space_cuda`
    (K2, when the frontend runs the fused detector) and
    `scale_space_torch` (the prefix-sum twin), `detect`, `field`,
    `pose_solver`, `matching`, `depth_filter`, `full_step`."""
    from rebvo_tpu_torch.frontend.step import MAX_IMG_VALUE
    from rebvo_tpu_torch.kernels.cuda_scale_space import \
        build_scale_space_cuda
    from rebvo_tpu_torch.kernels.depth_filter import estimate_quantile
    from rebvo_tpu_torch.kernels.edge_detect import (detect_keylines,
                                                     re_estimate_thresh,
                                                     update_detector_threshold)
    from rebvo_tpu_torch.kernels.field import build_field
    from rebvo_tpu_torch.kernels.match_depth import md_depth, md_match
    from rebvo_tpu_torch.kernels.pose_solver import FieldView, minimizer_rv
    from rebvo_tpu_torch.kernels.scale_space import build_scale_space

    p = fe.params
    cam = fe.cam
    dev = fe.device
    frame = fe._frame(frame)
    out: Dict[str, float] = {}

    if fe.use_fused:
        dt, ss = _timeit(dev, n, build_scale_space_cuda, frame, p.Sigma0,
                         p.KSigma, 3)
        out["scale_space_cuda"] = dt * 1e3
        dt, _ = _timeit(dev, n, build_scale_space, frame, p.Sigma0,
                        p.KSigma, 3)
        out["scale_space_torch"] = dt * 1e3
    else:
        dt, ss = _timeit(dev, n, build_scale_space, frame, p.Sigma0,
                         p.KSigma, 3)
        out["scale_space_torch"] = dt * 1e3

    thresh = update_detector_threshold(
        state.thresh, state.last_kl_num, p.ReferencePoints,
        p.DetectorAutoGain, p.DetectorMaxThresh, p.DetectorMinThresh)
    dt, det = _timeit(
        dev, n, detect_keylines, ss, thresh, K=p.KeylineMax,
        kl_max=p.MaxPoints, win_s=p.DetectorPlaneFitSize,
        per_hist=p.DetectorPosNegThresh, dog_thresh=p.DetectorDoGThresh,
        max_img_value=MAX_IMG_VALUE, cx=cam.cx, cy=cam.cy)
    out["detect"] = dt * 1e3
    klm, _, _ = det

    retuned = re_estimate_thresh(klm, p.TrackPoints, p.QCutOffNumBins)
    s_rho_q = estimate_quantile(state.klm, percentile=p.QCutOffQuantile,
                                nbins=p.QCutOffNumBins)

    dt, field_img = _timeit(dev, n, build_field, klm, retuned,
                            radius=min(p.FieldRadius, p.SearchRange),
                            height=cam.height, width=cam.width)
    out["field"] = dt * 1e3
    fv = FieldView.from_map(field_img, klm)

    dt, mres = _timeit(
        dev, n, minimizer_rv, state.Vel, state.W0, state.klm, fv,
        zfm=cam.zfm, cx=cam.cx, cy=cam.cy, width=cam.width,
        height=cam.height,
        max_r=torch.full((), float(p.SearchRange), device=dev),
        match_thresh=p.TrackerMatchThresh, max_s_rho=s_rho_q,
        match_num_min=torch.full((), 3, dtype=torch.int32, device=dev),
        k_huber=p.ReweigthDistance, iter_max=p.TrackerIterNum,
        init_iter=p.TrackerInitIterNum, init_type=p.TrackerInitType)
    out["pose_solver"] = dt * 1e3

    # vo.match_depth's two K5 calls (their plain versions on the CPU):
    # the forward transfer, an identity rotation and the field matching;
    # the regularisation, EKF and rescaling
    ok = torch.zeros((), dtype=torch.bool, device=dev)
    V, P_V = mres.Vel.contiguous(), mres.RVel.contiguous()
    dt, mt = _timeit(dev, n, md_match, state.klm, klm, state.field_img, V,
                     P_V, ok, cam=cam, params=p, m_id_f=mres.m_id_f,
                     W=torch.zeros(3, device=dev))
    out["matching"] = dt * 1e3
    dt, _ = _timeit(dev, n, md_depth, mt.new, V, ok, mt.nmatch,
                    state.frame_count, state.P_Kp, cam=cam, params=p,
                    rescale=True)
    out["depth_filter"] = dt * 1e3

    dt, _ = _timeit(dev, n, fe.step, state, frame, 1.0)
    out["full_step"] = dt * 1e3
    return out


def matching_gather_floor(fe, state, n: int = 20) -> float:
    """Time floor (ms) of the directed matcher's gather pattern: the same
    volume and locality of data-dependent gathers as the real stage
    ([K, 2*steps] field-image probes along stride-spaced line segments
    from random bases, one [hit_cap, 8] attribute-row gather per
    keyline) with all matching logic stripped."""
    p = fe.params
    dev = fe.device
    H, W = p.ImageHeight, p.ImageWidth
    K = p.KeylineMax
    stride = max(p.MatchFieldStride, 1)
    steps = int(p.SearchRange / stride) + 3
    lanes = 2 * steps
    hit_cap = 8

    rng = np.random.RandomState(7)
    bx = rng.randint(0, W, size=(K, 1))
    by = rng.randint(0, H, size=(K, 1))
    ang = rng.uniform(0, 2 * np.pi, size=(K, 1))
    off = (np.arange(lanes)[None, :] - steps) * stride
    ix = np.clip(bx + (np.cos(ang) * off).astype(np.int64), 0, W - 1)
    iy = np.clip(by + (np.sin(ang) * off).astype(np.int64), 0, H - 1)
    lin = torch.as_tensor(iy * W + ix, device=dev)
    jrows = torch.as_tensor(rng.randint(0, K, size=(K, hit_cap)),
                            device=dev)

    field_flat = state.field_img.reshape(-1)
    klm = state.klm
    attrs = torch.stack([klm.gx, klm.gy, klm.n_m, klm.rho, klm.s_rho, klm.x,
                         klm.y, klm.gx * 0], dim=-1)

    def kernel(fimg, at, idx, jr):
        probes = fimg[idx]                       # [K, lanes] gathers
        rows = at[jr]                            # [K, hit_cap, 8] rows
        return probes.sum() + rows.sum()

    dt, _ = _timeit(dev, n, kernel, field_flat, attrs, lin, jrows)
    return dt * 1e3


def roofline(fe, stage_ms: Dict[str, float]) -> Dict[str, float]:
    """Speed-of-light utilisation of the dominant stages from the JAX
    package's byte models, against the H100's 3.35e12 bytes/s
    (`*_mem_util`); `*_gbps` is the achieved rate in GB/s.

    * scale space: one frame read + five frame writes, 6*H*W*4 bytes.
    * pose solver: per LM evaluation the keyline SoA (~14 f32 arrays of K)
      and the field-view gathers (id + 6 attributes of 4 B per keyline),
      over I = 2*init_iter + 3*3 + iter_num + 2 evaluations.
    * directed matching: K*(16*4 + 2*steps*4 + 8*8*4 + 12*4) bytes.
    * depth filter: K*4*(3*16 + 2*8)*2 bytes.
    Gathers reach well under the peak rate on random addresses, so these
    are lower bounds on traffic: utilisation is understated, never
    overstated."""
    p = fe.params
    H, W = p.ImageHeight, p.ImageWidth
    K = p.KeylineMax
    out: Dict[str, float] = {}

    def put(name, nbytes, ms):
        s = ms * 1e-3
        out[f"{name}_gbps"] = nbytes / s / 1e9
        out[f"{name}_mem_util"] = nbytes / s / H100_MEM_BYTES_PER_S

    ss_key = ("scale_space_cuda" if "scale_space_cuda" in stage_ms
              else "scale_space_torch")
    put("scale_space", 6 * H * W * 4, stage_ms[ss_key])
    iters = 2 * p.TrackerInitIterNum + 3 * 3 + p.TrackerIterNum + 2
    put("pose_solver", iters * K * (14 + 7) * 4, stage_ms["pose_solver"])
    if "matching" in stage_ms:
        steps = int(p.SearchRange / max(p.MatchFieldStride, 1)) + 3
        put("matching", K * (16 * 4 + 2 * steps * 4 + 8 * 8 * 4 + 12 * 4),
            stage_ms["matching"])
    if "depth_filter" in stage_ms:
        put("depth_filter", K * 4 * (3 * 16 + 2 * 8) * 2,
            stage_ms["depth_filter"])
    return out


def step_cost_analysis(fe, state, frame) -> Dict[str, float]:
    """FLOPs of one step, counted by torch.utils.flop_counter: matrix
    products only (mm, bmm, addmm, convolutions), unlike XLA's cost
    analysis in the JAX package, which counts every operation. On the
    CPU the step forms its products as `torch.linalg.vecdot` of
    broadcast operands (core/numerics.matmul), counted here as an mm of
    the same shapes: 2 n k m."""
    from torch.overrides import TorchFunctionMode
    from torch.utils.flop_counter import FlopCounterMode

    class VecdotFlops(TorchFunctionMode):
        flops = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.linalg.vecdot:
                self.flops += 2 * math.prod(torch.broadcast_shapes(
                    args[0].shape, args[1].shape))
            return func(*args, **(kwargs or {}))

    with FlopCounterMode(display=False) as fc, VecdotFlops() as vd:
        fe.step(state, frame, 0.05)
    return dict(matmul_flops_per_step=float(fc.get_total_flops()
                                            + vd.flops))
