"""CLI: batched multi-sequence VO over the device mesh (PyTorch port of
rebvo_tpu/apps/run_batch.py: all sequences processed as one batched
computation).

Each mesh device carries a block of the sequences; the vmapped step
(parallel/mesh.shard_sequences: one CUDA graph per device on the card)
runs them lock-step. Sequences are synthetic (default; io/render's
procedural frames, seed b for sequence b) or EuRoC directories. Writes
one TUM trajectory per sequence (tray_seq{b}.txt) into --out-dir and
prints one JSON line: sequences, frames_each, wall_s, aggregate_fps,
devices.

    python -m rebvo_tpu_torch.apps.run_batch --synthetic 20 --batch 16
    python -m rebvo_tpu_torch.apps.run_batch --synthetic 20 --batch 4 --cpu
    python -m rebvo_tpu_torch.apps.run_batch --euroc dir1 dir2 --out-dir out

`--config` (a REBVO-format file) is the port's addition; the JAX
run_batch always runs the EuRoC defaults.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--euroc", nargs="*", default=[])
    ap.add_argument("--synthetic", type=int, default=0,
                    help="frames per synthetic sequence")
    ap.add_argument("--batch", type=int, default=0,
                    help="number of sequences (default: #devices)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--config", help="REBVO-format config file (default: "
                                     "the EuRoC defaults)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions of the kernels)")
    ap.add_argument("--devices", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from rebvo_tpu_torch.config import REBVOParameters, load_config
    from rebvo_tpu_torch.core.geometry import rotation_to_quaternion
    from rebvo_tpu_torch.frontend.step import VOFrontend
    from rebvo_tpu_torch.io.trajectory import write_tum
    from rebvo_tpu_torch.parallel.mesh import (data_mesh, gather,
                                               shard_batch, shard_sequences,
                                               stack_lanes)

    backend = "cpu" if args.cpu else "cuda"
    if backend == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_batch: no CUDA device (pass --cpu to run on "
                         "the CPU)")
    n_dev = args.devices or (torch.cuda.device_count()
                             if backend == "cuda" else 1)
    params = load_config(args.config) if args.config else REBVOParameters()

    # --- assemble B sequences of frames
    if args.euroc:
        from rebvo_tpu_torch.io.dataset import DatasetSequence, load_frame
        seqs = [DatasetSequence.euroc(d, with_imu=False) for d in args.euroc]
        B = len(seqs)
        n_frames = min(len(s.records) for s in seqs)

        def frame_at(b, i):
            rec = seqs[b].records[i]
            return rec.t, load_frame(rec.path)
    else:
        from rebvo_tpu_torch.io.render import synth_frames
        B = args.batch or n_dev
        n_frames = args.synthetic or 10
        pool = {b: synth_frames(params, 4, seed=b) for b in range(B)}

        def frame_at(b, i):
            return i / params.config_fps, pool[b][i % 4]

    # largest device count that divides the batch (an uneven split would
    # leave devices idle)
    n_mesh = max(d for d in range(1, min(n_dev, B) + 1) if B % d == 0)
    mesh = data_mesh(n_mesh, backend=backend)
    fes = [VOFrontend(params, device=d) for d in mesh]
    bootv = shard_sequences([fe.bootstrap for fe in fes], mesh)
    stepv = shard_sequences([fe.step_donated for fe in fes], mesh)
    states = shard_batch(stack_lanes(fes[0].init(), B), mesh)

    t0 = time.perf_counter()
    rows = []
    for i in range(n_frames):
        got = [frame_at(b, i) for b in range(B)]
        fb = shard_batch(torch.as_tensor(np.stack([f for _, f in got])),
                         mesh)
        tb = shard_batch(torch.tensor([t for t, _ in got],
                                      dtype=torch.float32), mesh)
        if i == 0:
            states = bootv(states, fb, tb)
        else:
            states, outs = stepv(states, fb, tb)
            rows.append([(o.nav.t, o.nav.Pos, o.nav.Pose) for o in outs])
    if backend == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    ts, pos, rot = (np.stack([gather([r[k] for r in blk]).numpy()
                              for blk in rows]) for k in range(3))
    for b in range(B):
        quat = rotation_to_quaternion(torch.as_tensor(rot[:, b])).numpy()
        write_tum(os.path.join(args.out_dir, f"tray_seq{b}.txt"), ts[:, b],
                  pos[:, b], quat)

    fps = B * (n_frames - 1) / wall
    print(json.dumps({"sequences": B, "frames_each": n_frames,
                      "wall_s": round(wall, 2),
                      "aggregate_fps": round(fps, 2),
                      "devices": len(mesh)}))


if __name__ == "__main__":
    main()
