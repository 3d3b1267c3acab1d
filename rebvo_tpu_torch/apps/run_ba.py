"""CLI: offline bundle adjustment over a saved keyframe list (PyTorch
port of rebvo_tpu/apps/run_ba.py).

The keyframe list (`run_vo --kf-every N`, or `VOSystem.TakeSnapshot`) is
re-matched into an edge-landmark BA problem and solved with the
Schur-complement Gauss-Newton backend on the CUDA device (`--cpu` for the
CPU). `--shards N` splits the landmarks into N blocks
(`partition_problem`) and solves with `ba_solve_sharded`, the blocks'
shares of the reduced system summed in one process on the one device
(the JAX package spreads them over N devices of its mesh). The last line
of standard output is one JSON object: keyframes, landmarks,
observations, cost_initial, cost_final, shards, out.

Examples:
    python -m rebvo_tpu_torch.apps.run_ba kf_list.npz --out kf_list_opt.npz
    python -m rebvo_tpu_torch.apps.run_ba kf_list.npz --cpu --rounds 1
    python -m rebvo_tpu_torch.apps.run_ba kf_list.npz --shards 4
"""

from __future__ import annotations

import argparse
import json
import os

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kf_list", help="keyframe npz (run_vo --kf-every, "
                                    "VOSystem.TakeSnapshot)")
    ap.add_argument("--out", default=None,
                    help="optimized keyframe npz (default: <in>_opt.npz)")
    ap.add_argument("--trajectory", default=None,
                    help="also write the optimized poses as a TUM file")
    ap.add_argument("--config", help="REBVO-format config file")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=4,
                    help="re-match/solve rounds: after each solve the "
                         "problem is rebuilt from the improved poses")
    ap.add_argument("--field-radius", type=int, default=8,
                    help="match-field search radius in pixels")
    ap.add_argument("--window", type=int, default=2,
                    help="match each keyframe into this many followers")
    ap.add_argument("--huber-k", type=float, default=3.0)
    ap.add_argument("--mutual-px", type=float, default=0.0,
                    help="round-trip back-projection cull tolerance "
                         "(px; 0 = off)")
    ap.add_argument("--revisit-dist", type=float, default=0.0,
                    help="also associate keyframe pairs whose positions "
                         "are within this distance (loop-closure pairs)")
    ap.add_argument("--revisit-min-gap", type=int, default=8)
    ap.add_argument("--landmark-stride", type=int, default=1,
                    help="thin the landmark set to every Nth keyline")
    ap.add_argument("--shards", type=int, default=0,
                    help="landmark blocks of the sharded solve (0 or 1: "
                         "ba_solve)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from rebvo_tpu_torch.backend.ba import (ba_solve, ba_solve_sharded,
                                            partition_problem,
                                            problem_from_keyframes)
    from rebvo_tpu_torch.backend.keyframe import (load_keyframes,
                                                  save_keyframes)
    from rebvo_tpu_torch.config import REBVOParameters, load_config
    from rebvo_tpu_torch.core.geometry import CameraModel

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_ba: no CUDA device (pass --cpu to run on the "
                         "CPU)")
    params = load_config(args.config) if args.config else REBVOParameters()
    cam = CameraModel.from_params(params)

    store = load_keyframes(args.kf_list, device=device)
    n_valid = int(store.valid.sum())
    if n_valid < 2:
        print(json.dumps({"error": "need >= 2 keyframes", "got": n_valid}))
        return 1

    R2, p2 = store.Pose, store.Pos
    all_costs = []
    for _ in range(max(args.rounds, 1)):
        prob = problem_from_keyframes(
            store._replace(Pose=R2, Pos=p2), cam.zfm, width=cam.width,
            height=cam.height, cx=float(cam.cx), cy=float(cam.cy),
            match_thresh=params.TrackerMatchThresh,
            field_radius=args.field_radius, window=args.window,
            mutual_px=args.mutual_px, revisit_dist=args.revisit_dist,
            revisit_min_gap=args.revisit_min_gap,
            landmark_stride=args.landmark_stride)
        if args.shards > 1:
            # rho comes back in the partitioned layout; only the poses
            # go into the store
            R2, p2, _, costs = ba_solve_sharded(
                R2, p2, partition_problem(prob, args.shards), cam.zfm,
                n_shards=args.shards, iters=args.iters,
                huber_k=args.huber_k)
        else:
            R2, p2, _, costs = ba_solve(R2, p2, prob, cam.zfm,
                                        iters=args.iters,
                                        huber_k=args.huber_k)
        all_costs.append(costs.cpu().numpy())
    costs = np.concatenate(all_costs)

    store2 = store._replace(Pose=R2, Pos=p2)
    out = args.out or os.path.splitext(args.kf_list)[0] + "_opt.npz"
    save_keyframes(out, store2)

    if args.trajectory:
        from rebvo_tpu_torch.core.geometry import rotation_to_quaternion
        from rebvo_tpu_torch.io.trajectory import write_tum
        live = store2.valid.cpu().numpy()
        write_tum(args.trajectory, store2.t.cpu().numpy()[live],
                  p2.cpu().numpy()[live],
                  rotation_to_quaternion(R2[store2.valid]).cpu().numpy())

    print(json.dumps({
        "keyframes": n_valid,
        "landmarks": int(prob.lvalid.sum()),
        "observations": int(prob.ovalid.sum()),
        "cost_initial": float(costs[0]),
        "cost_final": float(costs[-1]),
        "shards": max(args.shards, 1),
        "out": out,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
