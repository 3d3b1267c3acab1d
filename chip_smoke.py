"""Smoke run of the PyTorch port (rebvo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   — the card's name, and its power limit from nvidia-smi;
  2. build    — every kernel of the main path built by nvcc from csrc/;
  3. K1 check — the detector kernel against its plain PyTorch version on
                the card at 480x752 (a rendered and a uniform frame, two
                thresholds, a [4,480,752] batch), with their times and the
                card's bound;
  4. main     — the default-config mono path (752x480, KeylineMax=16384)
                over 60 rendered frames, every step after the first under
                torch.cuda.set_sync_debug_mode("error");
  5. profile  — 6 more steps under torch.profiler: host and device ms per
                step by stage span, device launches per step, the top
                PyTorch ops by device time;
  6. run_vo   — the run_vo entry point end to end on the card;
  7. cpu      — the first 8 frames of phase 4 on the CPU against the card;
  8. kernels  — the kernel list.
Then the nvidia-smi line, and last {"ok": true, "device": {...}}.
Longer artefacts go to chiprun_out/smoke/.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import rebvo_tpu_torch  # noqa: F401  (sets the package's numerics flags)
from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.frontend.step import VOFrontend
from rebvo_tpu_torch.io.render import render_lateral
from rebvo_tpu_torch.kernels import cuda_build
from rebvo_tpu_torch.kernels import cuda_scale_space as cs
from rebvo_tpu_torch.kernels.scale_space import scale_space_plan

OUT = os.path.join("chiprun_out", "smoke")
N_FRAMES = 60
N_PROFILE = 6
N_CPU = 8
KL_FLOOR = 2000          # keylines a textured 752x480 frame must give

# Published peaks of one H100 (NVIDIA's data sheet, SXM part, full
# power), against which every bound here is stated: memory bytes/s and
# float32 FLOP/s outside the tensor cores.
H100_MEM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_cuda(fn, n=100, flush=None):
    """Median ms of one call of `fn` by CUDA events (host launch gaps
    included); `flush` (if given) runs before each call, outside the
    timed window."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _device_timeline(prof):
    """({span name: [(start, end)]}, [(start, end, name)]) in us: the
    device-side ranges of the record_function spans, and the device
    activities (kernels, copies, fills) that ran."""
    from torch.autograd import DeviceType
    ranges, acts = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        r = (e.time_range.start, e.time_range.end)
        if e.is_user_annotation:
            ranges.setdefault(e.name, []).append(r)
        else:
            acts.append(r + (e.name,))
    return ranges, acts


def _inside(rng, acts):
    return [a for a in acts if a[0] >= rng[0] and a[1] <= rng[1]]


def device_ms(fn, n, flush):
    """Median device ms of one call of `fn`: the CUPTI durations of the
    device activities it launches, summed (torch.profiler), with `flush`
    before each call, outside the call's span."""
    from torch.profiler import record_function
    fn()

    def run():
        for _ in range(n):
            flush()
            with record_function("smoke.call"):
                fn()
    ranges, acts = _device_timeline(_profiled(run))
    per_call = [sum(a[1] - a[0] for a in _inside(r, acts))
                for r in ranges["smoke.call"]]
    return statistics.median(per_call) / 1e3


def k1_ops_per_pixel(sizes0, sizes1, w):
    """Float operations K1 does per pixel, counted from its passes."""
    box = sum(2 * (d - 1) + 2 for d in list(sizes0) + list(sizes1) if d > 1)
    dog, grad_t1, sign = 1, 6, 1
    pn = 4 * w + 2                       # sign window sum + |.| <= limit
    sums = 2 * w + 4 * w + 4 * w         # Vs, Vw, Hw of the DoG
    final = 3 * 2 * w + 3 + 3 + 6 + 6    # 3 window sums, 3 div, n2, xs/ys,
    return box + dog + grad_t1 + sign + pn + sums + final   # t3/t4/and


def compare(cand_k, cand_p):
    """(mask mismatches, max |field diff| at kernel-masked pixels)."""
    mism = int((cand_k.mask != cand_p.mask).sum().item())
    err = 0.0
    for f in ("theta_x", "theta_y", "xs", "ys", "n2_m"):
        d = (getattr(cand_k, f) - getattr(cand_p, f)).abs()
        err = max(err, float(torch.where(cand_k.mask, d,
                                         torch.zeros_like(d)).max()))
    return mism, err


def profile_steps(fe, state, frames, ts):
    """Step through `frames` under torch.profiler. Per step: the device
    activities and their busy ms, K1's device ms, and per stage span of
    VOFrontend.step its activities, busy ms and device-side range (under
    the profiler, so stretched by its host overhead); the PyTorch ops
    with the most device time. The full table goes to
    chiprun_out/smoke/profile.txt."""
    from torch.autograd import DeviceType
    n = len(frames)
    out = []

    def run():
        st = state
        for f, t in zip(frames, ts):
            st, _ = fe.step(st, f, t)
        out.append(st)
    t0 = time.perf_counter()
    prof = _profiled(run)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    ranges, acts = _device_timeline(prof)
    spans = {}
    for name, rs in sorted(ranges.items()):
        inner = [a for r in rs for a in _inside(r, acts)]
        spans[name] = {
            "activities": len(inner) / n,
            "busy_ms": sum(a[1] - a[0] for a in inner) / 1e3 / n,
            "range_ms_profiled": sum(r[1] - r[0] for r in rs) / 1e3 / n}
    avg = prof.key_averages()
    ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                  and not e.is_user_annotation),
                 key=lambda e: e.self_device_time_total, reverse=True)
    top = [{"op": e.key, "calls": e.count / n,
            "device_ms": e.self_device_time_total / 1e3 / n}
           for e in ops[:8]]
    with open(os.path.join(OUT, "profile.txt"), "w") as fh:
        fh.write(avg.table(sort_by="self_device_time_total", row_limit=60))
    return out[0], {
        "steps": n, "wall_ms_per_step_profiled": wall_ms,
        "device_activities_per_step": len(acts) / n,
        "device_busy_ms_per_step": sum(a[1] - a[0] for a in acts) / 1e3 / n,
        "k1_ms_per_step": sum(a[1] - a[0] for a in acts
                              if "detect_kernel" in a[2]) / 1e3 / n,
        "spans": spans, "top_ops": top}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")

    # ---- 1. device ------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if "H100" not in name:
        raise SystemExit(f"chip_smoke: expected an H100, found {name!r}")
    bw, flops = H100_MEM_BYTES_PER_S, H100_F32_FLOPS
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "mem_bytes_per_s": bw, "f32_flops": flops})

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    info = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT, "ptxas.txt"), "w") as fh:
        for k, v in info.items():
            fh.write(f"== {k}\n{v['ptxas']}\n")
    emit({"phase": "build", "seconds": build_s,
          "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"],
                          "ptxas": v["ptxas"].strip().splitlines()[-3:]}
                      for k, v in info.items()}})

    # ---- 3. K1 against its plain version ----------------------------------
    p = REBVOParameters()
    kw = dict(sigma0=p.Sigma0, k_sigma=p.KSigma,
              win_s=p.DetectorPlaneFitSize, per_hist=p.DetectorPosNegThresh,
              dog_thresh=p.DetectorDoGThresh, max_img_value=765.0)
    H, W = p.ImageHeight, p.ImageWidth
    frames = render_lateral(p, N_FRAMES + N_PROFILE)  # [N, 480, 752]
    rng = np.random.default_rng(0)
    uniform = rng.uniform(0, 765, (H, W)).astype(np.float32)
    batch = rng.uniform(0, 765, (4, H, W)).astype(np.float32)
    cases = []
    worst_err, worst_mism = 0.0, 0
    for label, img in (("rendered", frames[5]), ("uniform", uniform),
                       ("batch4", batch)):
        x = torch.as_tensor(img, device=dev)
        for th in (0.03, p.DetectorThresh):
            tht = torch.full((), th, dtype=torch.float32, device=dev)
            ck = cs.detect_candidates_cuda(x, tht, **kw)
            cp = cs.detect_candidates_plain(x, tht, **kw)
            torch.cuda.synchronize()
            mism, err = compare(ck, cp)
            n_edge = int(cp.mask.sum().item())
            cases.append({"frame": label, "thresh": th, "edges": n_edge,
                          "mask_mismatch": mism, "max_abs_err": err})
            worst_err = max(worst_err, err)
            worst_mism = max(worst_mism, mism)
    # Kernel and plain version round every operation alike (no fused
    # multiply-add on either side), so the mask must agree exactly.
    ok3 = worst_mism == 0 and worst_err < 5e-3
    x = torch.as_tensor(frames[5], device=dev)
    tht = torch.full((), p.DetectorThresh, dtype=torch.float32, device=dev)
    l2 = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    flush = l2.zero_                   # evict the 50 MB L2 between launches

    def run_k():
        cs.detect_candidates_cuda(x, tht, **kw)

    def run_p():
        cs.detect_candidates_plain(x, tht, **kw)

    # in turns on one card: plain, kernel, kernel, plain. `ms` is device
    # time (CUPTI); `call_ms` is what a caller waits for one wrapper call
    # (CUDA events), the Python launch path included.
    plain_a = device_ms(run_p, 50, flush)
    k_a = device_ms(run_k, 200, flush)
    k_b = device_ms(run_k, 200, flush)
    plain_b = device_ms(run_p, 50, flush)
    kernel_ms = statistics.median([k_a, k_b])
    plain_ms = statistics.median([plain_a, plain_b])
    call_ms = time_cuda(run_k, 200, flush)
    plain_call_ms = time_cuda(run_p, 100, flush)
    sizes0, sizes1, _, _ = scale_space_plan(p.Sigma0, p.KSigma, 3)
    px = H * W
    bytes_moved = px * (4 + 1 + 5 * 4)        # frame in; mask + 5 maps out
    ops = px * k1_ops_per_pixel(sizes0, sizes1, p.DetectorPlaneFitSize)
    t_bytes = bytes_moved / bw * 1e3
    t_ops = ops / flops * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    emit({"phase": "k1_check", "ok": ok3, "cases": cases,
          "kernel_ms": kernel_ms, "kernel_ms_runs": [k_a, k_b],
          "plain_ms": plain_ms, "plain_ms_runs": [plain_a, plain_b],
          "call_ms": call_ms, "plain_call_ms": plain_call_ms,
          "bytes": bytes_moved, "ops": ops, "bound_ms": bound_ms,
          "bound_by": bound_by, "library_ms": None,
          "timing": "ms: median device time per call (CUPTI via "
                    "torch.profiler), L2 flushed; call_ms: CUDA events"})
    if not ok3:
        return 1
    del l2

    # ---- 4. main path at full width -----------------------------------
    fe = VOFrontend(p, device="cuda")
    gpu_frames = torch.as_tensor(frames, device=dev)
    ts = [i / p.config_fps for i in range(N_FRAMES + N_PROFILE)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.detect_candidates_cuda.launches = 0
    state = fe.bootstrap(fe.init(), gpu_frames[0], ts[0])
    outs, step_ms = [], []
    for i in range(1, N_FRAMES):
        t0 = time.perf_counter()
        if i > 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, out = fe.step(state, gpu_frames[i], ts[i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = cs.detect_candidates_cuda.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    pos = np.stack([o.nav.Pos.cpu().numpy() for o in outs])
    kl = [int(o.nav.kl_num) for o in outs]
    klm = [int(o.nav.klm_num) for o in outs]
    est = [bool(o.nav.estimation_ok) for o in outs]
    est_share = float(np.mean(est[2:]))
    ok4 = (bool(np.all(np.isfinite(pos))) and min(kl) >= KL_FLOOR
           and est_share >= 0.9 and launches == N_FRAMES)
    steady = step_ms[5:]
    np.savez(os.path.join(OUT, "main_path.npz"), pos=pos, kl=kl, klm=klm,
             est=est, step_ms=step_ms)
    emit({"phase": "main_path", "ok": ok4, "frames": N_FRAMES,
          "k1_launches": launches, "kl_min": min(kl), "kl_floor": KL_FLOOR,
          "klm_min": min(klm), "est_ok_share_after_2": est_share,
          "pos_finite": bool(np.all(np.isfinite(pos))),
          "ms_per_frame_median": statistics.median(steady),
          "ms_per_frame_min": min(steady), "warmup_frames": 5,
          "timing": "host clock around step + synchronize",
          "peak_device_mb": peak_mb, "card": smi})
    if not ok4:
        return 1

    # ---- 5. where the step's time goes -------------------------------
    state, prof = profile_steps(fe, state, gpu_frames[N_FRAMES:],
                                ts[N_FRAMES:])
    busy = prof["device_busy_ms_per_step"]
    emit({"phase": "profile", **prof,
          "device_idle_share": 1.0 - busy / statistics.median(steady),
          "idle_share_of": "median unprofiled ms/frame of phase 4",
          "card": smi})

    # ---- 6. run_vo entry point ----------------------------------------
    from rebvo_tpu_torch.apps import run_vo
    rv_dir = os.path.join(OUT, "run_vo")
    run_vo.main(["--render", "40", "--max-frames", "40", "--out-dir",
                 rv_dir])
    with open(os.path.join(rv_dir, p.TrayFile)) as fh:
        rows = [ln for ln in fh if ln.strip()]
    tum = np.loadtxt(os.path.join(rv_dir, p.TrayFile))
    ok5 = len(rows) == 39 and bool(np.all(np.isfinite(tum)))
    emit({"phase": "run_vo", "ok": ok5, "tum_rows": len(rows),
          "expected_rows": 39})
    if not ok5:
        return 1

    # ---- 7. the same frames on the CPU --------------------------------
    # Tolerance: kl_num equal (the kernel and the plain version give the
    # same mask, and the detector threshold only depends on the counts);
    # Pos within 2% of the CPU run's path length plus 1e-4, since the
    # solver's sums run in another order on the card and the LM's
    # accept tests amplify that a little frame by frame.
    fe_cpu = VOFrontend(p, device="cpu")
    st = fe_cpu.bootstrap(fe_cpu.init(), frames[0], ts[0])
    cpu_pos, cpu_kl = [], []
    for i in range(1, N_CPU):
        st, out = fe_cpu.step(st, frames[i], ts[i])
        cpu_pos.append(out.nav.Pos.numpy())
        cpu_kl.append(int(out.nav.kl_num))
    cpu_pos = np.stack(cpu_pos)
    path = float(np.linalg.norm(cpu_pos[-1] - cpu_pos[0])) + \
        float(np.linalg.norm(cpu_pos[0]))
    tol = 0.02 * path + 1e-4
    dpos = float(np.abs(cpu_pos - pos[:N_CPU - 1]).max())
    ok6 = cpu_kl == kl[:N_CPU - 1] and dpos <= tol
    emit({"phase": "cpu_vs_card", "ok": ok6, "frames": N_CPU,
          "kl_cpu": cpu_kl, "kl_card": kl[:N_CPU - 1],
          "max_abs_pos_diff": dpos, "tolerance": tol})
    if not ok6:
        return 1

    # ---- 8. kernel list -----------------------------------------------
    emit({"kernels": [{
        "name": "detect_candidates", "route": "cuda",
        "source": "rebvo_tpu_torch/csrc/detect_candidates.cu",
        "replaces": "rebvo_tpu/kernels/pallas_scale_space.py:225",
        "replaces_function": "detect_candidates_pallas (_detect_kernel)",
        "launches": launches, "mask_mismatch": worst_mism,
        "max_abs_err": worst_err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
