"""Benchmark of the PyTorch port on one CUDA card: frames/s of the full
per-frame mono VO step (counterpart of the root bench.py, which measures
the JAX package on a TPU).

    python -m rebvo_tpu_torch.bench

Prints ONE JSON line:
  {"metric": "vo_step_fps_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N / 20.0, "detail": {...}}

Baseline: the reference runs as a 20 fps real-time system on MAV-class
CPUs (BASELINE.md). The default configuration (EuRoC camera, 752x480,
KeylineMax=16384) runs on rendered billboard frames (io/render), made
from fixed scene seeds: 16 frames of a moving camera (seed 101) for the
serial phases, 3 frames of each of 16 lanes (seeds 0-15) for the
batched phase, lane 0's for the stage breakdown.

Phases, each a function of the parameters and the device (the tests run
them small on the CPU; the command needs a card and fails without one):
  warm    — the kernels' build and the N=8 and N=2 graph captures;
  serial  — step_donated in chunks of frames, the dispatch cost of one
            op on the state, and the pure step;
  scan    — step_scan with N=8 (offline replay) and N=2 (live);
  batched — 16 distinct sequences as one vmapped step
            (parallel/mesh.shard_sequences: one CUDA graph on the card):
            bootstrap, then 40 batched steps alternating two frames; the
            same with TrackKeyFrames=0, and the keyframe tracking's share;
  stages  — profiling.stage_breakdown, roofline, matching_gather_floor and
            step_cost_analysis on the state after bootstrap + 2 steps.
Every chunk time is reported. `value` is the larger of the serial and
the batched frames/s, as in the JAX bench.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from rebvo_tpu_torch import profiling

N_SERIAL_FRAMES = 16          # distinct rendered frames cycled by the loops
SERIAL_SEED = 101
BATCH = 16                    # sequences of the batched phase


def _render_lane(params, n, seed):
    """One rendered sequence: billboards seen by a camera moving sideways
    at a speed that depends on the seed."""
    from rebvo_tpu_torch.io.render import render_billboards_seq
    pos = np.zeros((n, 3))
    pos[:, 0] = np.arange(n) * (0.01 + 0.002 * (seed % 5))
    return render_billboards_seq(n, width=params.ImageWidth,
                                 height=params.ImageHeight,
                                 zf=params.zf_mean, cx=params.PPx,
                                 cy=params.PPy, cam_positions=pos,
                                 seed=seed, ss=1)


def rendered_lanes(params, n_frames, n_lanes):
    """Distinct rendered sequences, one per lane: [L, n, H, W]."""
    return np.stack([_render_lane(params, n_frames, seed)
                     for seed in range(n_lanes)])


def _scan_chunks(frames, ch, n_chunks, t0):
    """(frames [ch, H, W], timestamps [ch]) on the frames' device for each
    chunk, cycling through frames[1:]."""
    ncyc = frames.shape[0] - 1
    out = []
    for c in range(n_chunks):
        idx = [1 + (c * ch + i) % ncyc for i in range(ch)]
        ts = t0 + 0.05 * (np.arange(ch) + c * ch)
        out.append((frames[idx], torch.as_tensor(
            ts, dtype=torch.float32).to(frames.device)))
    return out


def phase_warm(params, device, serial):
    """Wall seconds of the set-up a run pays once: the kernels' build
    (on the card) and the capture of the N=8 and N=2 graphs."""
    from rebvo_tpu_torch.frontend.step import VOFrontend
    from rebvo_tpu_torch.kernels import cuda_build
    t_start = time.perf_counter()
    if torch.device(device).type == "cuda":
        cuda_build.build_all()
    fe = VOFrontend(params, device=device)
    frames = torch.as_tensor(serial, device=device)
    st = fe.bootstrap(fe.init(), frames[0], 0.0)
    for ch, t0 in ((8, 0.05), (2, 0.5)):
        (f, ts), = _scan_chunks(frames, ch, 1, t0)
        st, _ = fe.step_scan(st, f, ts)
    profiling.sync(device)
    return dict(warm_wall_s=time.perf_counter() - t_start)


def phase_serial(params, device, serial, n_chunks=12, chunk=5):
    """Serial latency: step_donated in `n_chunks` chunks of `chunk` frames
    (host clock per chunk, ending in a synchronize), the cost of one op
    on the state (a no-op that adds a timestamp), and the pure step."""
    from rebvo_tpu_torch.frontend.step import VOFrontend
    fe = VOFrontend(params, device=device)
    frames = [torch.as_tensor(f, device=device) for f in serial]
    ncyc = len(frames) - 1

    def start():
        st = fe.bootstrap(fe.init(), frames[0], 0.0)
        st, _ = fe.step(st, frames[1], 0.05)
        profiling.sync(device)
        return st

    def run_loop(step_fn, st, n):
        times, i, out = [], 0, None
        for _ in range(n):
            t0 = time.perf_counter()
            for _ in range(chunk):
                st, out = step_fn(st, frames[1 + i % ncyc], 0.05 * (i + 2))
                i += 1
            profiling.sync(device)
            times.append(time.perf_counter() - t0)
        return chunk * n / sum(times), times, out, st

    st = start()
    st, _ = fe.step_donated(st, frames[1], 0.10)
    fps, times, out, st = run_loop(fe.step_donated, st, n_chunks)

    def noop(s, f, t):
        return s._replace(t=s.t + t), f[0, 0]

    st, _ = noop(st, frames[1], 0.0)
    profiling.sync(device)
    t0 = time.perf_counter()
    for _ in range(30):
        st, _ = noop(st, frames[1], 0.05)
    profiling.sync(device)
    dispatch_ms = (time.perf_counter() - t0) / 30 * 1e3

    fps_pure, times_pure, _, _ = run_loop(fe.step, start(),
                                          max(n_chunks // 2, 1))
    return dict(serial_fps=fps, kl_num=int(out.nav.kl_num),
                klm_num=int(out.nav.klm_num),
                chunk_ms=[t * 1e3 for t in times],
                serial_step_ms=1e3 / fps,
                dispatch_overhead_ms=dispatch_ms,
                serial_fps_nondonated=fps_pure,
                chunk_ms_nondonated=[t * 1e3 for t in times_pure])


def phase_scan(params, device, serial, n_chunks8=8, n_chunks2=24):
    """Chunked serial: step_scan with N=8 (one call per 8 frames, offline
    replay, `run_vo --chunk 8`) and N=2 (live: the outputs of every frame
    still come back each call, one frame late). Each chunk is timed by
    the host clock around the call and a synchronize, its frames and
    timestamps already on the device."""
    from rebvo_tpu_torch.frontend.step import VOFrontend
    fe = VOFrontend(params, device=device)
    frames = torch.as_tensor(serial, device=device)
    st = fe.bootstrap(fe.init(), frames[0], 0.0)
    res = {}
    t_next = 0.1
    for ch, n, key in ((8, n_chunks8, "serial_fps_scan8"),
                       (2, n_chunks2, "live_fps_chunk2")):
        chunks = _scan_chunks(frames, ch, n + 1, t_next)
        t_next += 0.05 * ch * (n + 1)
        st, _ = fe.step_scan(st, *chunks[0])      # capture, not timed
        profiling.sync(device)
        times = []
        for f, ts in chunks[1:]:
            t0 = time.perf_counter()
            st, _ = fe.step_scan(st, f, ts)
            profiling.sync(device)
            times.append(time.perf_counter() - t0)
        res[key] = ch * n / sum(times)
        res[f"chunk_ms_{ch}"] = [t * 1e3 for t in times]
    return res


def _measure_batched(params, device, lanes, n_iter):
    """Frames/s of `n_iter` batched steps over lanes [B, 3, H, W]: the
    bootstrap on frame 0 and one step on frame 1 (the captures on the
    card), then steps alternating frames 2 and 1, host clock ending in a
    synchronize."""
    from rebvo_tpu_torch.frontend.step import VOFrontend
    from rebvo_tpu_torch.parallel.mesh import shard_sequences, stack_lanes
    fe = VOFrontend(params, device=device)
    mesh = [torch.device(device)]
    B = lanes.shape[0]
    frames = torch.as_tensor(lanes, device=device)
    bootv = shard_sequences(fe.bootstrap, mesh)
    stepv = shard_sequences(fe.step_donated, mesh)
    ts = [torch.full((B,), 0.05 * i, device=device)
          for i in range(n_iter + 2)]
    states = bootv([stack_lanes(fe.init(), B)], [frames[:, 0]], [ts[0]])
    f1, f2 = [frames[:, 1]], [frames[:, 2]]
    states, _ = stepv(states, f1, [ts[1]])
    profiling.sync(device)
    t0 = time.perf_counter()
    for i in range(n_iter):
        states, _ = stepv(states, f1 if i % 2 else f2, [ts[i + 2]])
    profiling.sync(device)
    return B * n_iter / (time.perf_counter() - t0)


def phase_batched(params, device, lanes, n_iter=40):
    """The batched rate with keyframe tracking (the default) and without,
    and the tracking's share of the batched step."""
    fps = _measure_batched(params, device, lanes, n_iter)
    fps_nokf = _measure_batched(params.replace(TrackKeyFrames=0), device,
                                lanes, n_iter)
    return dict(batched_fps=fps, batch=lanes.shape[0],
                batched_fps_nokf=fps_nokf,
                kf_tracking_overhead_pct=100.0 * (fps_nokf - fps) / fps)


def phase_stages(params, device, lane, n=10):
    """The stage breakdown, roofline, gather floor and matrix-product
    FLOPs of the step on the state after bootstrap + 2 steps."""
    from rebvo_tpu_torch.frontend.step import VOFrontend
    fe = VOFrontend(params, device=device)
    frames = [torch.as_tensor(f, device=device) for f in lane]
    st = fe.bootstrap(fe.init(), frames[0], 0.0)
    st, _ = fe.step(st, frames[1], 0.05)
    st, _ = fe.step(st, frames[2], 0.10)
    profiling.sync(device)
    stage_ms = profiling.stage_breakdown(fe, st, frames[1], n=n)
    return dict(
        stage_ms=stage_ms,
        speed_of_light=profiling.roofline(fe, stage_ms),
        matching_gather_floor_ms=profiling.matching_gather_floor(fe, st,
                                                                 n=n),
        **profiling.step_cost_analysis(fe, st, frames[1]))


def main():
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    from rebvo_tpu_torch.config import REBVOParameters
    device = "cuda"
    params = REBVOParameters()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    serial = _render_lane(params, N_SERIAL_FRAMES, SERIAL_SEED)
    lanes = rendered_lanes(params, 3, BATCH)

    torch.cuda.reset_peak_memory_stats()
    warm = phase_warm(params, device, serial)
    serial_r = phase_serial(params, device, serial)
    scan = phase_scan(params, device, serial)
    batched = phase_batched(params, device, lanes)
    stages = phase_stages(params, device, lanes[0])

    serial_fps = max(serial_r["serial_fps"], scan["serial_fps_scan8"])
    fps = max(serial_fps, batched["batched_fps"])
    detail = {
        "serial_fps": serial_fps,
        **batched,
        "batched_frames": f"{BATCH} lanes of 3 rendered frames (seeds "
                          f"0-{BATCH - 1}), one vmapped step over all",
        "resolution": f"{params.ImageWidth}x{params.ImageHeight}",
        "keyline_budget": params.KeylineMax,
        "frames": "rendered billboards (io/render)",
        "serial_frames": f"{N_SERIAL_FRAMES} distinct rendered frames, "
                         f"moving camera, seed {SERIAL_SEED}",
        "kl_num": serial_r["kl_num"], "klm_num": serial_r["klm_num"],
        "serial_gap": {
            "serial_step_ms": serial_r["serial_step_ms"],
            "full_step_ms": stages["stage_ms"]["full_step"],
            "dispatch_overhead_ms": serial_r["dispatch_overhead_ms"],
            "serial_fps_donated": serial_r["serial_fps"],
            "serial_fps_nondonated": serial_r["serial_fps_nondonated"],
            "serial_fps_scan8": scan["serial_fps_scan8"],
            "live_fps_chunk2": scan["live_fps_chunk2"],
        },
        "chunk_ms": {
            "serial": serial_r["chunk_ms"],
            "nondonated": serial_r["chunk_ms_nondonated"],
            "scan8": scan["chunk_ms_8"],
            "chunk2": scan["chunk_ms_2"],
        },
        "warm_wall_s": warm["warm_wall_s"],
        "stage_ms": stages["stage_ms"],
        "matching_gather_floor_ms": stages["matching_gather_floor_ms"],
        "speed_of_light": stages["speed_of_light"],
        "matmul_flops_per_step": stages["matmul_flops_per_step"],
        "peak_device_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
    }
    print(json.dumps({
        "metric": "vo_step_fps_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / 20.0,
        "detail": detail,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
