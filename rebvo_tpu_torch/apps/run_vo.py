"""CLI: run mono VO on one sequence (the reference's rebvorun,
app/rebvorun/main.cpp:58-140), PyTorch port.

Runs on the CUDA device unless `--cpu` is given, and writes the TUM
trajectory (`TrayFile`) and the Matlab log (`LogFile`) into --out-dir.

Examples:
    # rendered billboard sequence, 60 frames, lateral camera path
    python -m rebvo_tpu_torch.apps.run_vo --render 60 --out-dir ./out

    # procedural frames on the CPU
    python -m rebvo_tpu_torch.apps.run_vo --synthetic 40 --cpu

    # 8 frames per call: on the card, one replay of a captured CUDA graph
    python -m rebvo_tpu_torch.apps.run_vo --render 60 --chunk 8

Rendered and synthetic frames come from an ideal pinhole camera, so no
undistortion is applied to them. Dataset input and the other modes of
the JAX package's run_vo are not ported yet; their flags fail with the
ROADMAP item that will port them.
"""

from __future__ import annotations

import argparse
import os
import time

_NOT_PORTED = {
    "euroc": "EuRoC input (io/dataset): ROADMAP queue 1, after M10",
    "imu": "visual-inertial mode: ROADMAP M10",
    "stereo": "stereo mode: ROADMAP M11",
    "kf_every": "the keyframe store (backend/keyframe): ROADMAP M14",
    "save_video": "video saving (io/video): ROADMAP M13",
    "interactive": "the interactive command loop: ROADMAP M13",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="REBVO-format config file")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N procedural frames")
    ap.add_argument("--render", type=int, default=0,
                    help="run N rendered billboard frames (lateral path)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions of the kernels)")
    ap.add_argument("--euroc")
    ap.add_argument("--imu", action="store_true")
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--chunk", type=int, default=0,
                    help="step N frames per call (VOFrontend.step_scan)")
    ap.add_argument("--kf-every", type=int, default=0)
    ap.add_argument("--save-video")
    ap.add_argument("--interactive", action="store_true")
    args = ap.parse_args(argv)

    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not ported to "
                     f"rebvo_tpu_torch yet: {item}")
    if not (args.synthetic or args.render):
        ap.error("give --synthetic N or --render N (dataset input is not "
                 f"ported yet: {_NOT_PORTED['euroc']})")

    import numpy as np
    import torch

    from rebvo_tpu_torch.config import REBVOParameters, load_config
    from rebvo_tpu_torch.frontend.step import VOFrontend
    from rebvo_tpu_torch.io.logger import RunLogger
    from rebvo_tpu_torch.io.render import render_lateral, synth_frames

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_vo: no CUDA device (pass --cpu to run on the "
                         "CPU)")
    params = load_config(args.config) if args.config else REBVOParameters()
    n = args.render or args.synthetic
    if args.max_frames:
        n = min(n, args.max_frames)
    if args.render:
        frames = render_lateral(params, n)
    else:
        base = synth_frames(params, min(n, 8))
        frames = [base[i % len(base)] for i in range(n)]
    # ideal pinhole frames; size the nav-log ring to the run so the whole
    # log comes back in one transfer
    params = params.replace(KcR2=0.0, KcR4=0.0, KcR6=0.0, KcP1=0.0,
                            KcP2=0.0, useUndistort=0,
                            NavLogCap=max(params.NavLogCap, n + 8))
    os.makedirs(args.out_dir, exist_ok=True)

    fe = VOFrontend(params, device=device)
    state = fe.init()
    chunk = []          # frame indices waiting for one step_scan call
    t_start = time.perf_counter()
    for i in range(n):
        t = i / params.config_fps
        if i == 0:
            state = fe.bootstrap(state, frames[i], t)
        elif args.chunk > 1:
            chunk.append(i)
            if len(chunk) == args.chunk:
                state, _ = fe.step_scan(
                    state, np.stack([frames[j] for j in chunk]),
                    np.asarray([j / params.config_fps for j in chunk],
                               np.float32))
                chunk.clear()
        else:
            # donated step: the previous state's buffers are reused
            state, _ = fe.step_donated(state, frames[i], t)
        if (i + 1) % 50 == 0:
            print(f"frame {i + 1}", flush=True)
    # the partial tail chunk, one frame at a time
    for j in chunk:
        state, _ = fe.step_donated(state, frames[j], j / params.config_fps)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start

    logger = RunLogger.from_device_log(state.navlog, state.navlog_n)
    tray = os.path.join(args.out_dir, params.TrayFile)
    logger.write_trajectory(tray)
    logger.write_mfile(os.path.join(args.out_dir, params.LogFile))
    r = logger.rows[-1] if logger.rows else {}
    print(f"processed {n} frames in {wall:.1f}s on {device} "
          f"({n / wall:.1f} fps); kl={r.get('kl_num')} "
          f"match={r.get('klm_num')}; trajectory -> {tray}")
    return logger


if __name__ == "__main__":
    main()
