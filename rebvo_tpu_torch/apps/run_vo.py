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
window or pair frame is read and no keyframe is captured, as in the JAX
package. `--kf-every N` pushes the state's edge map and pose into a
keyframe store on the device every N frames (no host read mid-run) and
writes it at exit to `<out-dir>/kf_list.npz` or `--save-kf PATH`: the
input of `run_ba`. `--save-video raw|mjpeg` encodes every input frame
(after undistortion) into `<out-dir>/video.rvv` (io/video; the
reference's VideoSave path, rebvo_third_t.cpp:249-256; mjpeg needs PIL).
`--interactive` runs the sequence through `VOSystem` under the
reference rebvorun's stdin command loop (q/s/p/r/k/f/a,
app/rebvorun/main.cpp:92-140), frames as the sequence gives them, as in
the JAX package. `--trace-out PATH` writes the run's host spans, the
device time of each step's stages and the counters
(`rebvo_tpu_torch.obs`) as Chrome-trace JSON on torch.profiler's epoch,
to open in Perfetto: where each frame's host and device time went. The
last line of standard output gives each kernel's launches in the run,
as JSON after `kernel_launches=`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HELP_KEYS = """Interactive commands (reference app/rebvorun/main.cpp:45-56):
  q: quit                        s: save keyframes + pose log, then quit
  p: snapshot current frame      r: reset depth/trajectory
  k: toggle keyframe pushes      f: toggle frame-by-frame (and advance)
  a: advance one frame (frame-by-frame mode)"""


def interactive_loop(params, seq, out_dir: str, max_frames: int = 0,
                     device="cuda"):
    """The reference rebvorun's stdin command loop
    (app/rebvorun/main.cpp:92-140) bound to the VOSystem API: stdin
    commands are applied between frames. Returns the VOSystem."""
    import queue
    import threading

    import numpy as np

    from rebvo_tpu_torch.io.png import write_png
    from rebvo_tpu_torch.system import VOSystem

    sys_ = VOSystem(params, device=device)
    cmds: "queue.Queue[str]" = queue.Queue()

    def reader():
        for line in iter(sys.stdin.readline, ""):
            for ch in line.strip():
                cmds.put(ch)

    threading.Thread(target=reader, daemon=True).start()
    print(_HELP_KEYS, flush=True)

    frame_by_frame = False
    kf_enabled = True
    savekf = False
    quit_ = False
    n_done = 0
    for item in seq:
        # frame-by-frame gate (rebvo_first_t.cpp:154-159): block until a
        # command arrives; 'a'/'f' advance
        while True:
            try:
                c = cmds.get(block=frame_by_frame, timeout=0.2)
            except queue.Empty:
                break
            if c == "q":
                quit_ = True
            elif c == "s":
                savekf = True
                quit_ = True
            elif c == "p":
                g = np.clip(np.asarray(item[1]) / 3.0, 0, 255).astype(
                    np.uint8)
                snap = os.path.join(out_dir, f"snapshot_{n_done:06d}.png")
                write_png(snap, g)
                print(f"snapshot -> {snap}", flush=True)
            elif c == "r":
                sys_.Reset()
                print("reset requested", flush=True)
            elif c == "k":
                kf_enabled = not kf_enabled
                print(f"keyframe pushes {'on' if kf_enabled else 'off'}",
                      flush=True)
            elif c == "f":
                frame_by_frame = not frame_by_frame
                break
            elif c == "a":
                break
            else:
                print(_HELP_KEYS, flush=True)
            if quit_ or not frame_by_frame:
                break
        if quit_:
            break
        t, frame, win = item[:3]
        pair = item[3] if len(item) == 4 else None
        sys_.kf_push_enabled = kf_enabled
        sys_.process_frame(frame, t, win, frame_pair=pair)
        n_done += 1
        if n_done % 50 == 0:
            print(f"frame {n_done}", flush=True)
        if max_frames and n_done >= max_frames:
            break
    if savekf:
        kf_path = os.path.join(out_dir, "kf_list.npz")
        poses_path = os.path.join(out_dir, "poses_list.npz")
        sys_.TakeSnapshot(kf_path, poses_path)
        print(f"saved KF -> {kf_path}; PG -> {poses_path}", flush=True)
    sys_.save_outputs(out_dir)
    print(f"processed {n_done} frames (interactive)", flush=True)
    return sys_


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
    ap.add_argument("--kf-every", type=int, default=0,
                    help="push a keyframe (edge map + pose) every N frames "
                         "into a store on the device, saved at exit: the "
                         "offline-BA input")
    ap.add_argument("--save-kf", default=None,
                    help="keyframe store output path "
                         "(default <out-dir>/kf_list.npz)")
    ap.add_argument("--save-video", choices=["raw", "mjpeg"],
                    help="buffer the encoded input stream to "
                         "<out-dir>/video.rvv (the reference's VideoSave "
                         "path, rebvo_third_t.cpp:249-256)")
    ap.add_argument("--interactive", action="store_true",
                    help="reference rebvorun stdin command loop "
                         "(q/s/p/r/k/f/a, app/rebvorun/main.cpp:92-140) "
                         "driving the VOSystem API")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's spans, stage device times and "
                         "counters (rebvo_tpu_torch.obs) as Chrome-trace "
                         "JSON to this path")
    args = ap.parse_args(argv)

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
    from rebvo_tpu_torch.kernels.cuda_scale_space import WRAPPERS

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

    launches0 = {fn.__name__: fn.launches for fn in WRAPPERS}
    if args.interactive:
        interactive_loop(params, seq, args.out_dir,
                         max_frames=args.max_frames, device=device)
        write_trace(args.trace_out)
        print_launches(launches0)
        return None

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
    kf_store = None
    if args.kf_every > 0:
        from rebvo_tpu_torch.backend.keyframe import (KeyframeStore,
                                                      push_keyframe,
                                                      save_keyframes)
        cap = n_total // args.kf_every + 2
        # depths stay in the map gauge of their capture, as in the JAX
        # package
        kf_store = KeyframeStore.empty(cap, params.KeylineMax,
                                       device=device)
    mono = not (params.ImuMode or stereo)
    if args.chunk > 1 and not (mono and kf_store is None):
        print("run_vo: --chunk is used only in mono vision-only runs "
              "without --kf-every", file=sys.stderr)
    chunk = [] if args.chunk > 1 and mono and kf_store is None else None
    venc = vout = None
    if args.save_video:
        from rebvo_tpu_torch.io.video import (VIDEO_ENCODER_TYPE_MJPEG,
                                              VIDEO_ENCODER_TYPE_RAW,
                                              VideoStreamWriter, make_encoder)
        etype = (VIDEO_ENCODER_TYPE_MJPEG if args.save_video == "mjpeg"
                 else VIDEO_ENCODER_TYPE_RAW)
        venc = make_encoder(etype, params.ImageWidth, params.ImageHeight)
        vout = VideoStreamWriter(os.path.join(args.out_dir, "video.rvv"),
                                 params.ImageWidth, params.ImageHeight)

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
        if kf_store is not None and n_done > 0 and \
                n_done % args.kf_every == 0:
            push_keyframe(kf_store, state.klm, state.t, state.K_scale,
                          state.Pose, state.Pos, state.Vel)
        if venc is not None:
            venc.push_frame(frame)
            vout.write(t, venc.pop_frame(), venc.encoder_type)
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
    if vout is not None:
        vout.close()
    if kf_store is not None:
        kf_path = args.save_kf or os.path.join(args.out_dir, "kf_list.npz")
        save_keyframes(kf_path, kf_store)
        n_kf = int(kf_store.count)
        if n_kf >= cap:
            print(f"WARNING: keyframe ring filled (capacity {cap}); "
                  f"earliest keyframes may have been overwritten")
        print(f"saved {n_kf} keyframes -> {kf_path}")

    logger = RunLogger.from_device_log(state.navlog, state.navlog_n)
    tray = os.path.join(args.out_dir, params.TrayFile)
    logger.write_trajectory(tray)
    logger.write_mfile(os.path.join(args.out_dir, params.LogFile))
    r = logger.rows[-1] if logger.rows else {}
    print(f"processed {n_done} frames in {wall:.1f}s on {device} "
          f"({n_done / wall:.1f} fps); kl={r.get('kl_num')} "
          f"match={r.get('klm_num')}; trajectory -> {tray}")
    write_trace(args.trace_out)
    print_launches(launches0)
    return logger


def write_trace(path) -> None:
    """`--trace-out`: the ring of rebvo_tpu_torch.obs as Chrome-trace
    JSON."""
    if path:
        from rebvo_tpu_torch import obs
        obs.dump(path)
        print(f"trace ({len(obs.units())} units, counters "
              f"{json.dumps(obs.counters())}) -> {path}", flush=True)


def print_launches(launches0) -> None:
    """The last line: each kernel's launches since `launches0`."""
    from rebvo_tpu_torch.kernels.cuda_scale_space import WRAPPERS
    print("kernel_launches=" + json.dumps(
        {fn.__name__: fn.launches - launches0[fn.__name__]
         for fn in WRAPPERS}), flush=True)


if __name__ == "__main__":
    main()
