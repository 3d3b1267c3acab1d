"""Multi-process scaling harness: weak scaling and cross-process
correctness of the sharded compute paths (PyTorch port of
rebvo_tpu/apps/run_multihost.py).

The launcher spawns N worker processes on a free localhost port, joined
into a `torch.distributed` process group (parallel/distributed.py; the
backend is `--backend`, gloo by default). Each worker runs the same work
(a batch of tiny VO sequences stepped through
parallel/mesh.shard_sequences), so N processes do N times the work:
weak-scaling efficiency = T_1 / T_N (ideal 1.0). The workers also check
the all-reduce (a rank-coded sum) and, with `--check-ba`, the sharded
Schur BA (backend/ba.ba_solve_sharded, one landmark block per rank,
all-reduced) against the one-process `ba_solve`, by cost trajectories:
the initial cost exact, the floors within 1e-3 relative. `--big-ba` runs
the 64-keyframe x 100,000-landmark problem across the group.

Workers compute on the CUDA device unless `--cpu`; under gloo the ranks
share card 0 (gloo stages CUDA tensors through the host: the numbers say
that it runs, not how fast), under nccl rank r takes card r.

    python -m rebvo_tpu_torch.apps.run_multihost --nprocs 2 --check-ba
    python -m rebvo_tpu_torch.apps.run_multihost --nprocs 2 --batch 2 \\
        --iters 4 --check-ba --cpu

Workers print `WORKER_RESULT {...}` lines; the launcher prints one JSON
object (`scaling[]` with n_processes, efficiency, t_n_s, global_fps,
psum_ok, ba_parity_err; `ba_big`) and writes it to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


def _tiny_params():
    from rebvo_tpu_torch.config import REBVOParameters
    return REBVOParameters().replace(
        ImageWidth=96, ImageHeight=64, PPx=48.0, PPy=32.0,
        ZfX=60.0, ZfY=60.0, KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0,
        KeylineMax=512, MaxPoints=512, ReferencePoints=256, TrackPoints=512,
        SearchRange=8, MatchMaxSteps=12, GlobalMatchThreshold=2)


def _synth_local_frames(params, B, n, rank):
    import numpy as np
    H, W = params.ImageHeight, params.ImageWidth
    rng = np.random.RandomState(1234 + rank)
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    out = np.empty((n, B, H, W), np.float32)
    for i in range(n):
        for b in range(B):
            img = 300.0 + 250.0 * np.sign(
                np.sin(xx / 9.0 + 0.3 * i + b) * np.sin(yy / 7.0 - 0.2 * i))
            out[i, b] = img + rng.rand(H, W) * 8.0
    return out


# Iterations of both solves in _ba_check: the floor. A monocular BA
# agrees with another order of its sums only up to its gauge (ROADMAP
# queue 3, known divergences), so midway one solve can be a step behind
# the other: on the card, where the block sums' atomics run in any order,
# the two costs after 4 iterations parted by 2.2e-3 of the first cost in
# one run and by 1.6e-7 in another. Both are compared where they
# converge, as chip_smoke.py's in-process sharded check compares them.
BA_ITERS = 8


def _ba_check(dev, nprocs, rank, big):
    """The sharded BA across the group against `ba_solve` in this process:
    (parity error, the big problem's report or None)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rebvo_tpu_torch.backend import ba as bam
    from rebvo_tpu_torch.parallel import distributed as pd

    F, L, OBS_PER = (64, 100_000, 3) if big else (4, 64, 4)
    rng = np.random.RandomState(7)                # identical on all ranks
    _, p_true, _, prob = bam.synth_ring_problem(F, L, OBS_PER, 60.0, seed=7,
                                                device=dev)
    R0 = torch.eye(3, device=dev).repeat(F, 1, 1)
    p0 = torch.as_tensor(p_true + rng.uniform(-0.05, 0.05, (F, 3)).astype(
        np.float32), device=dev)
    _, _, _, costs_ref = bam.ba_solve(R0, p0, prob, 60.0, iters=BA_ITERS)

    # this rank's landmark block of the partitioned problem, and the
    # observations of those landmarks
    part = bam.partition_problem(prob, nprocs)
    nl, no = part.rho.shape[0] // nprocs, part.obs_lm.shape[0] // nprocs
    local = bam.BAProblem(*[x[rank * nl:(rank + 1) * nl] if i < 5 else
                            x[rank * no:(rank + 1) * no]
                            for i, x in enumerate(part)])
    mesh = pd.global_data_mesh(dev)
    R0g, p0g = pd.replicate_global(mesh, (R0, p0))
    local = pd.host_local_to_global(mesh, local)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, costs_sh = bam.ba_solve_sharded(R0g, p0g, local, 60.0,
                                             n_shards=1, iters=BA_ITERS,
                                             group=dist.group.WORLD)
    cs = pd.fetch_replicated(costs_sh)
    wall = time.perf_counter() - t0
    # parity in a gauge-free metric: monocular BA has a similarity
    # gauge, so equal optima can differ in raw pose entries; compare the
    # cost trajectories (initial cost exact, floors within f32 noise)
    cr = pd.fetch_replicated(costs_ref)
    err = float(abs(cs[0] - cr[0]) / max(cr[0], 1e-12)
                + abs(cs[-1] - cr[-1]) / max(cr[0], 1e-12))
    report = None
    if big:
        report = dict(F=F, L=L, OBS=int(prob.obs_lm.numel()),
                      wall_s=wall, cost0=float(cs[0]),
                      cost_final=float(cs[-1]),
                      converged=bool(cs[-1] < cs[0] * 2e-3))
    return err, report


def worker(rank: int, nprocs: int, coord: str, batch: int, iters: int,
           check_ba: bool, big_ba: bool, backend: str, cpu: bool) -> None:
    import torch
    import torch.distributed as dist

    from rebvo_tpu_torch.parallel import distributed as pd
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    pd.initialize(coord, nprocs, rank, backend)
    if cpu:
        dev = torch.device("cpu")
    elif backend == "nccl":
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cuda", 0)
    assert dist.get_world_size() == nprocs

    # --- collective sanity: all-reduce of rank-coded blocks --------------
    local = torch.full((1, 4), float(rank + 1), device=dev)
    dist.all_reduce(local)
    expect = sum((r + 1) for r in range(nprocs))
    psum_ok = bool(torch.all(local == expect))
    assert psum_ok, (local, expect)

    # --- batched VO steps on this rank's sequences (weak scaling) -------
    from rebvo_tpu_torch.frontend.step import VOFrontend
    from rebvo_tpu_torch.parallel.mesh import shard_sequences, stack_lanes
    params = _tiny_params()
    fe = VOFrontend(params, device=dev)
    B = batch                                     # per-process batch
    frames = torch.as_tensor(_synth_local_frames(params, B, 3, rank),
                             device=dev)
    mesh = [dev]
    bootv = shard_sequences(fe.bootstrap, mesh)
    stepv = shard_sequences(fe.step_donated, mesh)
    ts = [torch.full((B,), 0.05 * i, device=dev) for i in range(iters + 2)]
    states = bootv([stack_lanes(fe.init(), B)], [frames[0]], [ts[0]])
    states, _ = stepv(states, [frames[1]], [ts[1]])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(iters):
        states, out = stepv(states, [frames[1 + (i % 2)]], [ts[i + 2]])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fps_local = B * iters / dt
    pos_finite = bool(torch.all(torch.isfinite(out[0].nav.Pos)))

    ba_err = ba_big = None
    if check_ba or big_ba:
        ba_err, ba_big = _ba_check(dev, nprocs, rank, big_ba)

    result = dict(rank=rank, nprocs=nprocs, backend=backend,
                  device=str(dev), batch=B, iters=iters, wall_s=dt,
                  fps_local=fps_local, pos_finite=pos_finite,
                  psum_ok=psum_ok, ba_err=ba_err, ba_big=ba_big)
    print("WORKER_RESULT " + json.dumps(result), flush=True)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def _spawn(nprocs: int, args, check_ba: bool, big_ba: bool = False):
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(nprocs):
        cmd = [sys.executable, "-m", "rebvo_tpu_torch.apps.run_multihost",
               "--worker", "--rank", str(rank), "--nprocs", str(nprocs),
               "--coord", coord, "--batch", str(args.batch),
               "--iters", str(args.iters), "--backend", args.backend]
        cmd += ["--check-ba"] * check_ba + ["--big-ba"] * big_ba + \
            ["--cpu"] * args.cpu
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    results, failed = [], None
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=args.timeout)
            if pr.returncode != 0 and failed is None:
                failed = f"worker rc={pr.returncode}; output:\n{out[-4000:]}"
            for line in out.splitlines():
                if line.startswith("WORKER_RESULT "):
                    results.append(json.loads(line[len("WORKER_RESULT "):]))
    except subprocess.TimeoutExpired:
        failed = "worker timed out"
    finally:
        for pr in procs:              # no worker outlives the launcher
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    if failed:
        raise RuntimeError(failed)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--coord", default="")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--check-ba", action="store_true")
    ap.add_argument("--big-ba", action="store_true")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--cpu", action="store_true",
                    help="workers compute on the CPU (gloo)")
    ap.add_argument("--nprocs-list", default="",
                    help="comma list, e.g. 2,4: run the whole scaling "
                         "study and emit one combined report")
    ap.add_argument("--big-ba-at", type=int, default=0,
                    help="run the 64KF x 1e5-landmark cross-process BA "
                         "at this N of the scaling study (0 = the largest)")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    if args.worker:
        worker(args.rank, args.nprocs, args.coord, args.batch, args.iters,
               args.check_ba, args.big_ba, args.backend, args.cpu)
        return None
    if not args.cpu:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("run_multihost: no CUDA device (pass --cpu to "
                             "run the workers on the CPU)")

    ns = ([int(x) for x in args.nprocs_list.split(",") if x]
          if args.nprocs_list else [args.nprocs])
    big_at = args.big_ba_at or max(ns)

    # weak scaling: the same per-process work at N=1 and each N
    base = _spawn(1, args, check_ba=False)
    t1 = base[0]["wall_s"]
    points = []
    ba_big = None
    for n in ns:
        multi = _spawn(n, args, check_ba=args.check_ba,
                       big_ba=(args.big_ba or args.big_ba_at > 0)
                       and n == big_at)
        tn = max(r["wall_s"] for r in multi)
        ba_errs = [r["ba_err"] for r in multi if r["ba_err"] is not None]
        bigs = [r["ba_big"] for r in multi if r["ba_big"]]
        if bigs:
            ba_big = dict(bigs[0], n_processes=n,
                          parity_err=max(ba_errs) if ba_errs else None)
        points.append(dict(
            n_processes=n, efficiency=t1 / tn, t_n_s=tn,
            global_fps=sum(r["fps_local"] for r in multi),
            psum_ok=all(r["psum_ok"] for r in multi),
            pos_finite=all(r["pos_finite"] for r in multi),
            ba_parity_err=max(ba_errs) if ba_errs else None))

    report = dict(
        metric="multihost_weak_scaling_efficiency",
        value=points[-1]["efficiency"],
        headline_n_processes=points[-1]["n_processes"], unit="ratio",
        per_process_batch=args.batch, iters=args.iters, t1_s=t1,
        backend=args.backend, device="cpu" if args.cpu else "cuda",
        scaling=points, ba_big=ba_big,
        topology=f"N processes on one host, torch.distributed "
                 f"({args.backend}) over localhost TCP; "
                 + ("CPU workers" if args.cpu else
                    "CUDA workers" + (" sharing card 0" if args.backend ==
                                      "gloo" else ", one card each")))
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
