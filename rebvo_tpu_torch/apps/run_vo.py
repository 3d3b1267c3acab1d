"""CLI: run VO/VIO on one sequence (the reference's rebvorun,
app/rebvorun/main.cpp:58-140), PyTorch port.

Runs on the CUDA device unless `--cpu` is given, and writes the TUM
trajectory (`TrayFile`) and the Matlab log (`LogFile`) into --out-dir.

Examples:
    # EuRoC directory, visual-inertial
    python -m rebvo_tpu_torch.apps.run_vo --euroc /data/MH_01_easy/mav0 \\
        --imu --out-dir ./out

    # EuRoC directory, stereo (cam0 + cam1), with or without --imu
    python -m rebvo_tpu_torch.apps.run_vo --euroc /data/MH_01_easy/mav0 \\
        --stereo --imu

    # the dataset a REBVO-format config names (DataSetDir/DataSetFile)
    python -m rebvo_tpu_torch.apps.run_vo --config GlobalConfig

    # procedural frames on the CPU
    python -m rebvo_tpu_torch.apps.run_vo --synthetic 40 --cpu

    # rendered billboard sequence, 60 frames, lateral camera path; 8
    # frames per call: on the card, one replay of a captured CUDA graph
    python -m rebvo_tpu_torch.apps.run_vo --render 60 --chunk 8

As in the JAX package's run_vo, every input frame goes through the
config's undistortion when `UseUndistort` is set, synthetic frames
included; `--render` (the port's own pinhole renderer) zeroes the
distortion instead, since its frames come from an ideal pinhole camera.
In IMU mode (`--imu` or `ImuMode`) a frame with an IMU window runs
`step_imu_donated`, one without (`--synthetic`, `--render`) the mono
step. In stereo mode (`--stereo` or `StereoAvaiable`) a dataset's cam1
stream is paired with cam0 and undistorted through cam1's own map; a
frame whose pair was dropped, and every `--synthetic` or `--render`
frame, runs without the pair. `--chunk` is used only where no IMU
window or pair frame is read, as in the JAX package. The other modes of the JAX
package's run_vo are not ported yet; their flags fail with the ROADMAP
item that will port them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_NOT_PORTED = {
    "kf_every": "the offline-BA keyframe dump: ROADMAP M14",
    "save_video": "video saving (io/video): ROADMAP M13",
    "interactive": "the interactive command loop: ROADMAP M13",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="REBVO-format config file")
    ap.add_argument("--euroc", help="EuRoC mav0 directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N procedural frames")
    ap.add_argument("--render", type=int, default=0,
                    help="run N rendered billboard frames (lateral path)")
    ap.add_argument("--imu", action="store_true",
                    help="visual-inertial mode (ImuMode=2)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions of the kernels)")
    ap.add_argument("--stereo", action="store_true",
                    help="stereo mode (StereoAvaiable=1): pairs the cam1 "
                         "stream")
    ap.add_argument("--chunk", type=int, default=0,
                    help="step N frames per call (VOFrontend.step_scan); "
                         "mono only")
    ap.add_argument("--kf-every", type=int, default=0)
    ap.add_argument("--save-video")
    ap.add_argument("--interactive", action="store_true")
    args = ap.parse_args(argv)

    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not ported to "
                     f"rebvo_tpu_torch yet: {item}")

    import numpy as np
    import torch

    from rebvo_tpu_torch.config import REBVOParameters, load_config
    from rebvo_tpu_torch.frontend.step import VOFrontend
    from rebvo_tpu_torch.io.dataset import (DatasetSequence, imu_window_size,
                                            read_cam_imu_se3)
    from rebvo_tpu_torch.io.logger import RunLogger
    from rebvo_tpu_torch.io.render import render_lateral, synth_frames
    from rebvo_tpu_torch.io.undistort import (apply_undistort,
                                              build_undistort_map)

    params = load_config(args.config) if args.config else REBVOParameters()
    if args.imu:
        params = params.replace(ImuMode=2)
    if args.stereo:
        params = params.replace(StereoAvaiable=1)
    if not (args.synthetic or args.render or args.euroc
            or params.DataSetFile):
        ap.error("give --synthetic N, --render N, --euroc DIR, or a "
                 "--config whose DataSetFile names a dataset")
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_vo: no CUDA device (pass --cpu to run on the "
                         "CPU)")

    if args.render or args.synthetic:
        n = args.render or args.synthetic
        if args.render:
            frames = render_lateral(params, n)
            # ideal pinhole frames: nothing to undistort
            params = params.replace(KcR2=0.0, KcR4=0.0, KcR6=0.0, KcP1=0.0,
                                    KcP2=0.0, useUndistort=0)
        else:
            base = synth_frames(params, min(n, 8))
            frames = [base[i % len(base)] for i in range(n)]
        seq = [(i / params.config_fps, frames[i], None) for i in range(n)]
    elif args.euroc:
        seq = DatasetSequence.euroc(
            args.euroc, with_imu=bool(params.ImuMode),
            stereo=bool(params.StereoAvaiable),
            window_size=imu_window_size(params),
            time_desinc=params.TimeDesinc)
    else:
        seq = DatasetSequence.from_params(params)
    stereo = isinstance(seq, DatasetSequence) and seq.stereo
    n_total = len(seq)
    if args.max_frames:
        n_total = min(n_total, args.max_frames)
    # size the nav-log ring to the run so the whole log comes back in one
    # transfer
    params = params.replace(NavLogCap=max(params.NavLogCap, n_total + 8))
    os.makedirs(args.out_dir, exist_ok=True)

    fe = VOFrontend(params, device=device)
    umap = (build_undistort_map(fe.cam, device=device)
            if params.useUndistort else None)
    umap_pair = (build_undistort_map(fe.cam_pair, device=device)
                 if stereo and params.useUndistort else None)
    # Camera->IMU extrinsics (the reference applies them inside the IMU
    # integration, imugrabber.cpp:135-160,217-250), as float32
    R_c2i = T_c2i = None
    if params.ImuMode and params.CamImuSE3File:
        R_np, T_np = read_cam_imu_se3(params.CamImuSE3File)
        R_c2i = torch.as_tensor(R_np, dtype=torch.float32).to(device)
        T_c2i = torch.as_tensor(T_np, dtype=torch.float32).to(device)
    mono = not (params.ImuMode or stereo)
    if args.chunk > 1 and not mono:
        print("run_vo: --chunk is used only in mono vision-only runs",
              file=sys.stderr)
    chunk = [] if args.chunk > 1 and mono else None

    state = fe.init()
    n_done = 0
    t_start = time.perf_counter()
    for item in seq:
        t, frame, win = item[:3]
        # the pair is None when the cam1 stream dropped this frame
        pair = item[3] if stereo else None
        frame = torch.as_tensor(frame, dtype=torch.float32).to(device)
        if umap is not None:
            frame = apply_undistort(umap, frame)
        if pair is not None:
            pair = torch.as_tensor(pair, dtype=torch.float32).to(device)
            if umap_pair is not None:
                pair = apply_undistort(umap_pair, pair)
        if n_done == 0:
            state = fe.bootstrap(state, frame, t, pair)
        elif chunk is not None:
            chunk.append((frame, t))
            if len(chunk) == args.chunk:
                state, _ = fe.step_scan(
                    state, torch.stack([f for f, _ in chunk]),
                    np.asarray([tt for _, tt in chunk], np.float32))
                chunk.clear()
        elif params.ImuMode and win is not None:
            # donated steps: the previous state's buffers are reused
            state, _ = fe.step_imu_donated(state, frame, t, win, R_c2i,
                                           T_c2i, pair)
        else:
            state, _ = fe.step_donated(state, frame, t, pair)
        n_done += 1
        if n_done % 50 == 0:
            print(f"frame {n_done}", flush=True)
        if n_done >= n_total:
            break
    # the partial tail chunk, one frame at a time
    for f, tt in chunk or ():
        state, _ = fe.step_donated(state, f, tt)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start

    logger = RunLogger.from_device_log(state.navlog, state.navlog_n)
    tray = os.path.join(args.out_dir, params.TrayFile)
    logger.write_trajectory(tray)
    logger.write_mfile(os.path.join(args.out_dir, params.LogFile))
    r = logger.rows[-1] if logger.rows else {}
    print(f"processed {n_done} frames in {wall:.1f}s on {device} "
          f"({n_done / wall:.1f} fps); kl={r.get('kl_num')} "
          f"match={r.get('klm_num')}; trajectory -> {tray}")
    return logger


if __name__ == "__main__":
    main()
