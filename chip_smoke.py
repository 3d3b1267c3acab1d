"""Smoke run of the PyTorch port (rebvo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   — the card's name, and its power limit from nvidia-smi;
  2. build    — every kernel in csrc/ built by nvcc, all at once;
  3. K1 check — the detector kernel against its plain PyTorch version on
                the card at 480x752 (a rendered and a uniform frame, two
                thresholds, a [4,480,752] batch), at ragged shapes (120x188,
                57x93, 9x13, 481x753) and at plans of other sigma0 (run by
                the runtime-plan instantiation), with their times, the
                card's bound, the kernel's ptxas resources and occupancy;
  3b. K2 check — the scale-space kernel likewise (the same inputs and
                shapes, its own plans), and the prefix-sum twin's time and
                difference;
  3c. K3 check — the pose solver kernel against its plain version on the
                card at the default config (752x480, K=16384): the
                minimizer_rv calls of 16 rendered steps, each alone and the
                16 as one vmapped launch (m_id_f and the float32 bits of
                Vel, W0 and score equal, the rest within a float32 ulp, two
                for rel_error), the kernel's and the plain version's device
                ms for 1 and 16 lanes beside the bound (the map once and
                each valid slot's two gathers an evaluation, at the card's
                memory rate), its ptxas
                resources and resident clusters, and its launch count;
  3d. K3 3-dof — the solver's translation-only mode (minimizer_v) against
                minimizer_v_plain on the card at 752x480, K=16384: the
                minimizer_v calls of 16 visual-inertial steps on phase 10's
                fixture (written first, here), the camera moving and the
                scale filter running, each alone and the 16 as one vmapped
                launch (m_id_f and the float32 bits of Vel and score equal,
                RVel within a float32 ulp), device ms against the plain
                version and the bound, ptxas resources, resident clusters,
                launches;
  3e. K4 check — the keyframe tracker kernel against its plain version on
                the card at the default config (752x480, K=16384): the
                correct_and_augment calls of 16 rendered steps, each alone
                and the 16 as one vmapped launch (m_f, m_kf, fow_m and
                back_m equal), the kernel's and the plain body's device ms
                for 1 and 16 lanes beside the bound (both maps read once,
                both id arrays written once, at the card's memory rate),
                the wrapper call's ms, its ptxas resources and resident
                clusters, and its launch count;
  3f. K5 check — the match-and-depth kernels against their plain versions
                on the card at the default config (752x480, K=16384): the
                md_match and md_depth calls of 16 rendered steps, each alone
                and the 16 as one vmapped launch of each (every output bit
                for bit), the kernels' and the plain versions' device ms
                for 1 and 16 lanes beside the bound (the maps read once and
                the rows written once, at the card's memory rate), both
                ops' call ms, their ptxas resources and resident clusters,
                and their launch counts;
  4. main     — the default-config mono path (752x480, KeylineMax=16384)
                over 60 rendered frames, every step after the first under
                torch.cuda.set_sync_debug_mode("error");
  5. profile  — 6 more steps under torch.profiler: host and device ms per
                step by stage span, device launches per step, the top
                PyTorch ops by device time;
  4b. scan    — from the state after phase 4, 16 frames through the
                per-frame step against step_scan's CUDA graphs with N=8
                and N=2, replayed under set_sync_debug_mode("error"):
                state and outputs bit for bit against the eager steps,
                and against eager steps with the stage's plain versions
                (`plain_stage`: K5 off);
  6. run_vo   — the run_vo entry point end to end on the card;
  6b. chunk   — run_vo --chunk 8 against phase 6's trajectory;
  7. cpu      — the first 8 frames of phase 4 on the CPU against the card;
  8. bench    — python -m rebvo_tpu_torch.bench, in this process (its
                JSON line is printed as it is), its batched phase's
                batched_fps and batched_fps_nokf numbers;
  10. vi_main — the visual-inertial path at the default config with
                ImuMode=2 (752x480, KeylineMax=16384, EuRoC distortion):
                io/render.write_euroc_vi writes 62 frames and their 200 Hz
                IMU as a EuRoC directory under chiprun_out/smoke/euroc_vi,
                DatasetSequence.euroc reads them back, and 60 of them run
                apply_undistort + step_imu_donated, every step after the
                first under set_sync_debug_mode("error"); held to
                tests/test_vi_step.py's bars at full width, K inside the
                filter's clamp on every filtered frame, and the trajectory
                near the written path, similarity- and rigidly aligned;
  10e. vi_scan — the last 16 frames of phase 10 again, from its state
                before them (the scale filter running), as two replays
                of step_scan's visual-inertial CUDA graph with N=8 under
                set_sync_debug_mode("error"), against the same frames
                stepped eagerly through step_imu_donated, with K5 and
                with the stage's plain versions: state and outputs bit
                for bit; K1, K3's 3-dof mode and each K5 kernel 8 launches
                a replay, K3's 6-dof mode none; one capture, its host
                windows' samples counted and none cut;
  10b. vi_profile — 2 more VI steps under torch.profiler, as phase 5
                (spans vo.imu and vo.imu_filter included);
  10c. vi_run_vo — run_vo --euroc DIR --imu on the card against phase 10;
  10d. vi_cpu — the first 20 VI frames on the CPU against the card
                (kl_num on every frame, Pos before the scale filter's
                start), and at each of the 5 filtered frames among them
                one CPU step from the card's state against the card's
                step (K, g, Pos);
  11. stereo_main — the stereo path at the default config with
                StereoAvaiable=1, on phase 10's directory (which holds cam1
                too): 60 frames through both cameras' undistortion and
                step_donated with the pair, every step after the first
                under set_sync_debug_mode("error"); K1 twice a frame, the
                keyline and stereo-match floors, and the trajectory's
                scale against the written path with no scale fitted, each
                bar between what the JAX package reaches on the fixture
                and a collapse;
  11f. stereo_scan — the last 16 frames of phase 11 again, from its
                state before them, as two replays of step_scan's stereo
                CUDA graph with N=8 (frames_pair) under
                set_sync_debug_mode("error"), against the same frames
                stepped eagerly through step_donated with the pair, with
                K5 and with the stage's plain versions: state and outputs
                bit for bit; K1 16 launches a replay, K3, K4 and each K5
                kernel 8; one capture, the pairs counted and none
                unpaired;
  11b. stereo_profile — 2 more stereo steps under torch.profiler (spans
                vo.stereo and vo.detect, K1's share of the device time);
  11c. stereo_run_vo — run_vo --euroc DIR --stereo against phase 11, and
                run_vo --euroc DIR --stereo --imu (K in band, the written
                path's metric scale);
  11d. stereo_cpu — the first 8 stereo frames on the CPU against the card;
  11e. vosystem — VOSystem over phase 4's first 20 frames, in turns
                with step_donated on a twin frontend (trajectory, keyframe
                store, pose log, the pose-graph optimizer, a snapshot read
                back, ms/frame of both and the system's host read alone);
  12. ba      — the offline BA at tests/test_ba_scale.py's scale (64
                keyframes, 100,000 landmarks, 3 observations each, poses
                perturbed as there): synth_ring_problem, then ba_solve on
                the card with 3 iterations (its costs, ms and peak MB),
                the device ms of the reduced camera system's [L,6F] x
                [L,6F] product, and the card against the port's CPU solve
                of the same input, both at the floor (8 iterations);
  12b. parity_row — one parity row through apps/parity.evaluate_sequence
                on the card: `loop`, 240 frames at 752x480, --ba-every 10,
                no reference; its ATE beside the JAX package's PARITY_r05
                number, run_ba's JSON line, K1 once a frame;
  13. batched — 16 rendered lanes at the default config through
                parallel/mesh.shard_sequences on the card (one CUDA graph
                each for the vmapped bootstrap and step): bootstrap + 10
                steps, every step after the first under
                set_sync_debug_mode("error"); each lane against that lane
                stepped alone by step_donated (kl_num equal, Pos within
                phase 7's bar); K1 launched once per batched call; device
                activities and busy ms of one batched replay against one
                single step's; ms per batched frame, frames/s, peak MB;
                the ops vmap ran by its per-lane fallback; K1 at
                [16,480,752] against its plain version, with its device ms
                beside its bound;
  13b. run_batch — python -m rebvo_tpu_torch.apps.run_batch --synthetic 20
                --batch 16: its JSON line and 16 TUM files that parse;
  14. distributed — ba_solve_sharded with 4 landmark blocks in this
                process on phase 12's problem against ba_solve, both at
                the floor; run_ba --shards 4 against --shards 1 on phase
                12b's keyframe store, both at the floor; and python -m
                rebvo_tpu_torch.apps.run_multihost --nprocs 2 --check-ba
                --backend gloo (the two ranks share the card): the
                all-reduce check and the sharded BA's parity;
  15. m13_m15 — the last modules at the default config, on phase 4's
                frames: VOSystem with VideoNetEnabled=1 (raw video) over 21
                frames to an EdgeMapReceiver in a thread (at least 18 of
                the 20 packets, each equal to that frame's edge map
                quantized on the host; K1 once a frame; ms a frame with and
                without the sender, in turns with a twin system); fill_depth
                on the card against the CPU on each sent edge map in every
                bound_mode (60x94 grid, 60 iterations); build_ocgrid and
                ray_cut_visibility over the fills' world points, card
                against the CPU; apps.visualizer.run over loopback with its
                dense fills on the card; run_vo --save-video raw (10
                frames, pixels equal); run_vo --interactive with 's' after
                frame 50; save_state after 10 frames, load_state, 5 more
                steps against the run that was not interrupted;
  9. kernels  — the kernel list, with K1's, K3's, K4's and K5's
                launches on every path (K3 once a step on phases 4, 4b,
                11, 11f, 11e and 13; K4 and each K5 kernel once a step on
                phases 4, 4b, 10, 10e, 11, 11f, 11e and 13: once a
                batched call, 8 a replay of N=8; K5's md.match and
                md.depth counters once an eager step, 10 an N=8 capture,
                0 a replay).
Each path (phases 4, 4b, 6, 6b, 8, 10, 10e, 10c, 11, 11f, 11c, 11e, 12b,
13, 15)
starts with every kernel's launch count at 0 and reports the counts it
ends with. Each phase line carries `elapsed_s`, the seconds since the script started.
Then the nvidia-smi line, and last {"ok": true, "device": {...}}. Longer
artefacts go to chiprun_out/smoke/.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import rebvo_tpu_torch  # noqa: F401  (sets the package's numerics flags)
from rebvo_tpu_torch.config import REBVOParameters, save_config
from rebvo_tpu_torch import obs
from rebvo_tpu_torch.frontend.imu import ImuWindow, stack_windows
from rebvo_tpu_torch.frontend.step import VOFrontend
from rebvo_tpu_torch.graphs import tree_leaves
from rebvo_tpu_torch.io.dataset import DatasetSequence, imu_window_size
from rebvo_tpu_torch.io.render import render_lateral, write_euroc_vi
from rebvo_tpu_torch.io.trajectory import align_umeyama, ate_rmse
from rebvo_tpu_torch.io.undistort import apply_undistort, build_undistort_map
from rebvo_tpu_torch.kernels import cuda_build
from rebvo_tpu_torch.kernels import cuda_scale_space as cs
from rebvo_tpu_torch.kernels.registry import WRAPPERS
from rebvo_tpu_torch.kernels.scale_space import (build_scale_space,
                                                 scale_space_plan)
# published peaks of one H100 against which every bound here is stated
from rebvo_tpu_torch.profiling import H100_F32_FLOPS, H100_MEM_BYTES_PER_S

T_START = time.perf_counter()
OUT = os.path.join("chiprun_out", "smoke")
N_FRAMES = 60
N_PROFILE = 6
N_SCAN = 16
N_CPU = 8
N_VI = 60                # VI frames of phase 10
N_VI_PROFILE = 2         # and of phase 10b after them
N_VI_CPU = 20            # VI frames of phase 10d: the filter runs from 15
N_VI_SCAN, VI_SCAN_N = 16, 8   # phase 10e: phase 10's last frames, chunk
VI_K_FLOOR, VI_K_CEIL = 1e-2, 100.0   # phase 10's open band for K
VI_K_SETTLED = 0.05      # its last 10 frames' K within this of the final
VI_ATE_SHAPE = 0.20      # phase 10's ATE bars, shares of the path extent:
VI_ATE_METRIC = 0.25     # similarity-aligned, and rigidly aligned,
VI_SCALE_BAND = (0.5, 2.0)   # and the similarity alignment's scale
# phase 10d, one CPU step from the card's state at each filtered frame
# against the card's step: the bars of tests/test_torch_vi_step.py's
# sensitive single step (the port from JAX's state), K relative, g
# absolute (|g| = 9.8), Pos absolute
VI_CPU_K_RTOL, VI_CPU_G_ATOL, VI_CPU_POS_ATOL = 5e-2, 5e-2, 1e-3
G_DOWN = np.asarray([0.0, 1.0, 0.0])     # gravity in write_euroc_vi's
                                         # camera frame (+y, no roll)
N_ST = 60                # stereo frames of phase 11 (phase 10's fixture)
N_ST_PROFILE = 2         # and of phase 11b after them
N_ST_CPU = 8             # stereo frames of phase 11d
N_ST_SCAN, ST_SCAN_N = 16, 8   # phase 11f: phase 11's last frames, chunk
N_SYS = 20               # mono frames of phase 11e (phase 4's)
# phase 12: tests/test_ba_scale.py's problem, 3 Gauss-Newton iterations
BA_F, BA_L, BA_OBS, BA_ZFM, BA_ITERS = 64, 100_000, 3, 200.0, 3
BA_COST_DROP = 1e-2      # the final cost at most this share of the first
BA_ATE_DROP = 0.3        # the poses' ATE to the truth, share of the start's
# card against CPU: the monocular gauge is left to the damping, so sums in
# another order take each Gauss-Newton step on another path (one solve
# rejects the step another accepts) and 3 iterations end at different
# points of the descent (9.4e-4 m apart on an H100 at 700 W). Both are
# compared at the floor instead, after BA_ITERS_FLOOR iterations: on the
# CPU, the observations in another order leave the poses 4.4e-7 m apart
# after a similarity alignment there (2.2e-6 m after 6); the bar is 20x
# that, 1e-5 of the ring's 1 m diameter
BA_ITERS_FLOOR, BA_CARD_CPU_ATE = 8, 1e-5
# phase 13: lanes, batched steps after the bootstrap
N_LANES, N_BATCH_STEPS = 16, 10
# phase 14: the sharded solve's blocks; the parity bars of run_multihost
# (the JAX worker's: initial cost exact, floors within f32 noise) and of
# the floors, relative to the first cost
BA_SHARDS, BA_SHARD_RTOL, MULTIHOST_PARITY = 4, 1e-3, 1e-3
BA_STORE_ITERS = 40      # run_ba's iterations on 12b's store
# phase 12b: the `loop` row of PARITY_r05 (the JAX package, on the CPU):
# ATE 0.0265 m over frames 40-239; the smoke's bar is twice it (the
# table's tolerance, PERF.md, is 25% or 5 mm)
PARITY_FRAMES, PARITY_KF_EVERY = 240, 10
PARITY_JAX_ATE, PARITY_ATE_BAR = 0.0265, 2.0
# phase 11's bars, each between what the JAX package itself reaches on
# this fixture at full width (run_vo --cpu --euroc --stereo, UsePallas=0)
# and a fault's reading on the card (python3 tools/stereo_bars.py): the
# stereo_num on every frame after the first (JAX: at least 2074); its
# share of klm_num on frames 2-9, while the detector threshold settles
# (JAX: 0.163 at the second frame; a dropped pair: 0), and from frame 10
# (JAX and the port: 0.396; cam1 three frames late: 0.199); over the
# moving frames, against the written path with no scale fitted, the
# similarity alignment's scale (JAX: 0.518; twice the baseline: 0.247,
# cam1 late: 0.361; half the baseline: 1.028, StereoVelRescale=0: 1.051,
# a dropped pair: 2.92) and the rigidly aligned ATE's share of the path's
# extent (JAX: 0.352; twice the baseline: 0.646). The band holds the
# reference's behaviour on this scene, which loses the scale on the
# return leg: a true metric scale of 1 lies outside it.
ST_NUM_FLOOR, ST_NUM_SHARE_EARLY, ST_NUM_SHARE = 1000, 0.1, 0.3
ST_SHARE_SETTLED = 10
ST_SCALE_BAND = (0.4, 0.75)
ST_ATE_METRIC = 0.5
# phase 11c's stereo-VIO run: the rigidly aligned ATE over the filtered
# frames (JAX at full width: 0.0246 of the extent, K within 0.92-1.10)
ST_VIO_ATE_METRIC = 0.25
ST_CPU_NUM = 0.01        # phase 11d: stereo_num, CPU against the card
N_TEL = 20               # phase 15: telemetry packets sent (after bootstrap)
TEL_MIN_PACKETS = 18     # of them received (the channel is lossy)
FILL_BLOCK, FILL_ITERS = 8, 60     # a 60x94 grid at 752x480
# fill_depth card against CPU: rho and s_rho within this share of each
# array's largest entry (tests/test_torch_depth_filler.py's FILL_REL)
FILL_REL = 2e-5
VIS_MISMATCH = 0.01      # ray-cut visibility: counted mismatch share
# occupancy grid: OC_CELLS a side over the box of the rays (the last
# frame's camera to the first frame's surfels); surfels outside it, and
# any farther than 1 / SURFEL_RHO_MIN, stay out
OC_CELLS = 256
SURFEL_RHO_MIN = 0.1
N_VIDEO = 10             # run_vo --save-video frames
N_CKPT, N_RESUME = 10, 5     # frames before the checkpoint, steps after
KL_FLOOR = 2000          # keylines a textured 752x480 frame must give
SS_MAPS = ("img0", "img1", "dog", "dx", "dy")
CAND_MAPS = ("theta_x", "theta_y", "xs", "ys", "n2_m")
RAGGED = ((120, 188), (57, 93), (9, 13), (481, 753))
# sigma0 of plans other than the default, run by the runtime instantiation:
# K1 halo 5 (size-1 boxes skipped) and 6; K2 halo 3 and 8 (the largest)
K1_PLANS = (1.2, 1.4)
K2_PLANS = (1.2, 2.4)


def emit(obj):
    """Print `obj` as one JSON line (a phase line gains `elapsed_s`, the
    seconds since the script started) and append it to lines.jsonl."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
    line = json.dumps(obj)
    print(line, flush=True)
    with open(os.path.join(OUT, "lines.jsonl"), "a") as fh:
        fh.write(line + "\n")


def zero_launches():
    for fn in WRAPPERS:
        fn.launches = 0


def read_launches():
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def map_tree(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*[map_tree(fn, sub) for sub in tree])


def clone_tree(tree):
    return map_tree(torch.clone, tree)


def leaves_differing(a, b) -> int:
    """How many leaves of a and b differ (NaN equal to NaN); -1 when they
    have another number of leaves."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return -1
    return sum(not (x.shape == y.shape and x.dtype == y.dtype and bool(
        ((x == y) | (x != x) & (y != y)).all())) for x, y in zip(la, lb))


def pos_tolerance(pos):
    """Phase 7's bar between two runs of one sequence: 2% of the path
    length (end-to-start plus start-from-origin) plus 1e-4."""
    path = float(np.linalg.norm(pos[-1] - pos[0])) + \
        float(np.linalg.norm(pos[0]))
    return 0.02 * path + 1e-4


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


def box_ops_per_pixel(sizes0, sizes1):
    """Float operations of both box chains per pixel: per pass of width
    d, d-1 adds each way and two multiplies by the reciprocals."""
    return sum(2 * (d - 1) + 2 for d in list(sizes0) + list(sizes1)
               if d > 1)


def k2_ops_per_pixel(sizes0, sizes1):
    """Float operations K2 does per pixel: the chains, the DoG, dx, dy."""
    return box_ops_per_pixel(sizes0, sizes1) + 1 + 2


def k1_ops_per_pixel(sizes0, sizes1, w):
    """Float operations K1 does per pixel, counted from its passes."""
    box = box_ops_per_pixel(sizes0, sizes1)
    dog, grad_t1, sign = 1, 6, 1
    pn = 4 * w + 2                       # sign window sum + |.| <= limit
    sums = 2 * w + 4 * w + 4 * w         # Vs, Vw, Hw of the DoG
    final = 3 * 2 * w + 3 + 3 + 6 + 6    # 3 window sums, 3 div, n2, xs/ys,
    return box + dog + grad_t1 + sign + pn + sums + final   # t3/t4/and


def compare(cand_k, cand_p):
    """(mask mismatches, max |field diff| at kernel-masked pixels, max
    |field diff| over all pixels)."""
    mism = int((cand_k.mask != cand_p.mask).sum().item())
    err = err_all = 0.0
    for f in CAND_MAPS:
        d = (getattr(cand_k, f) - getattr(cand_p, f)).abs()
        err = max(err, float(torch.where(cand_k.mask, d,
                                         torch.zeros_like(d)).max()))
        err_all = max(err_all, float(d.max()))
    return mism, err, err_all


def ptxas_resources(log, key=None):
    """{"fixed" | "runtime": {registers, spill bytes, stack, static shared
    bytes}} of each instantiation, from nvcc -Xptxas -v; `key(entry)`
    names an entry function's record instead."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            cur = out.setdefault(key(name) if key else
                                 "fixed" if "ILb1E" in name else "runtime",
                                 {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            sm = re.search(r"(\d+) bytes smem", ln)
            cur.update(registers=int(m.group(1)),
                       static_smem_bytes=int(sm.group(1)) if sm else 0)
    return out


def kernel_resources(name, log):
    """ptxas resources of both instantiations of kernel `name`, the
    dynamic shared bytes and threads per block its launcher passes (read
    from its library), and the resident blocks per SM at those."""
    res = ptxas_resources(log)
    smem, threads = cs.launch_config(name)
    for inst, r in res.items():
        r["dynamic_smem_bytes"] = smem
        r["threads_per_block"] = threads
        r["blocks_per_sm"] = cs.blocks_per_sm(name, inst == "fixed")
    return res


N_K3_LANES = 16
N_K4_LANES = 16
N_K3V_LANES, K3V_FROM = 16, 13   # phase 3d: VI steps 13-28, the camera
#                                  moving from 13, the filter from 15
# K3 against its plain version: the fields whose float32 bits must agree,
# and the ulps allowed elsewhere (float64 sums and solves in another order
# round the other way near a float32 boundary; rel_error divides two norms)
K3_EXACT = ("Vel", "W0", "score")
K3_ULPS = {"RVel": 1, "RW0": 1, "W_X": 1, "rel_error": 2,
           "rel_error_score": 1}


def _ulps(a, b):
    """Largest distance in float32 steps (NaNs equal to NaNs)."""
    def ordered(x):
        i = x.reshape(-1).view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(a) - ordered(b)).abs()
    nan = torch.isnan(a.reshape(-1)) & torch.isnan(b.reshape(-1))
    return int(torch.where(nan, 0, d).max())


# the 3-dof mode (MinimizerVResult) likewise
K3V_EXACT = ("Vel", "score")
K3V_ULPS = {"RVel": 1}


def k3_resource_key(entry):
    """pose_lm_kernel<6> (minimizer_rv) or pose_lm_kernel<3>."""
    return "6dof" if "ILi6E" in entry else "3dof"


def compare_pose(k, r, exact=K3_EXACT, ulps=K3_ULPS):
    """K3's result `k` against the plain version's `r`."""
    res = {"m_id_f_mismatch": int((k.m_id_f != r.m_id_f).sum()),
           "matched": int((r.m_id_f >= 0).sum())}
    for f in exact:
        res[f"{f}_ulps"] = _ulps(getattr(k, f), getattr(r, f))
    for f in ulps:
        res[f"{f}_ulps"] = _ulps(getattr(k, f), getattr(r, f))
    res["ok"] = (res["m_id_f_mismatch"] == 0
                 and all(res[f"{f}_ulps"] == 0 for f in exact)
                 and all(res[f"{f}_ulps"] <= n for f, n in ulps.items()))
    return res


def k3_times(run_k, run_p, run_k16, run_p16):
    """Device ms of one K3 mode and its plain version, in turns (plain,
    kernel, kernel, plain; CUPTI, L2 flushed), for one lane and for 16
    lanes in one vmapped call, and the wrapper call's ms."""
    l2 = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device="cuda")
    flush = l2.zero_
    plain_a = device_ms(run_p, 5, flush)
    k_a = device_ms(run_k, 50, flush)
    k16_a = device_ms(run_k16, 20, flush)
    k_b = device_ms(run_k, 50, flush)
    k16_b = device_ms(run_k16, 20, flush)
    plain_b = device_ms(run_p, 5, flush)
    return {"kernel_ms": statistics.median([k_a, k_b]),
            "kernel_ms_runs": [k_a, k_b],
            "kernel_ms_16": statistics.median([k16_a, k16_b]),
            "kernel_ms_16_runs": [k16_a, k16_b],
            "plain_ms": statistics.median([plain_a, plain_b]),
            "plain_ms_runs": [plain_a, plain_b],
            "plain_ms_16": device_ms(run_p16, 3, flush),
            "call_ms": time_cuda(run_k, 100, flush)}


def k3_launch_config(mode, K):
    """The shared bytes, threads and cluster of K3's `mode` ("pose_lm":
    6 dof, "pose_v": 3) at K slots, and its resident clusters."""
    lib = cuda_build.library("pose_lm")
    intp = ctypes.POINTER(ctypes.c_int)
    max_clusters = getattr(lib, f"{mode}_max_clusters")
    max_clusters.argtypes = [ctypes.c_int, intp]
    max_clusters.restype = ctypes.c_int
    config = getattr(lib, f"{mode}_launch_config")
    config.argtypes = [ctypes.c_int] + [intp] * 4
    config.restype = None
    cfg = [ctypes.c_int(0) for _ in range(4)]
    config(K, *[ctypes.byref(c) for c in cfg])
    nclu = ctypes.c_int(0)
    err = max_clusters(K, ctypes.byref(nclu))
    return {"smem_bytes": cfg[0].value, "threads": cfg[1].value,
            "cluster": cfg[2].value, "max_active_clusters": nclu.value,
            "max_active_clusters_err": err}


def k3_bytes(K, valid, vote, n_eval):
    """Bytes one K3 call must move at the least: the map's 9 fields
    (valid a byte), the vote mask and m_id_f once, and in each of
    `n_eval` evaluations each valid slot's two gathers (the field image's
    entry, 6 floats of the matched keyline's row)."""
    once = K * (1 + 8 * 4 + 4) + (0 if vote is None else K)
    return once + n_eval * int(valid.sum()) * (4 + 6 * 4)


def k3_line(phase, ok, cases, lanes16, launches, K, n_eval, bytes_call,
            bytes16, valid_slots, times, info, mode, smi):
    """Emit a K3 check line; returns the numbers of the kernel list."""
    bw = H100_MEM_BYTES_PER_S
    bound_ms, bound16_ms = bytes_call / bw * 1e3, bytes16 / bw * 1e3
    res = ptxas_resources(info["pose_lm"]["ptxas"], k3_resource_key)
    emit({"phase": phase, "ok": ok, "cases": cases, "lanes16": lanes16,
          "launches": launches, "expected_launches": len(cases) + 1,
          "K": K, "evaluations": n_eval, "bytes": bytes_call,
          "valid_slots": valid_slots,
          "bound_ms": bound_ms, "bound_ms_16": bound16_ms,
          "bound_by": "bytes (latency-bound: 13 dependent rounds)",
          **times, "x_bound": times["kernel_ms"] / bound_ms,
          "x_bound_16": times["kernel_ms_16"] / bound16_ms,
          "library_ms": None, "resources": res,
          **k3_launch_config(mode, K), "card": smi,
          "timing": "as k1_check; _16: 16 lanes in one vmapped call"})
    return {**{k: times[k] for k in ("kernel_ms", "kernel_ms_16", "call_ms",
                                     "plain_ms", "plain_ms_16")},
            "bound_ms": bound_ms, "bound_ms_16": bound16_ms,
            "x_bound": times["kernel_ms"] / bound_ms,
            "resources": res.get("6dof" if mode == "pose_lm" else "3dof"),
            "check_launches": launches}


def k3_phase(smi, p, frames, info):
    """Phase 3c (module docstring). Returns (the kernel's numbers for the
    kernel list, ok)."""
    from rebvo_tpu_torch.frontend import step as step_mod
    from rebvo_tpu_torch.kernels import pose_solver as ps
    dev = torch.device("cuda")
    calls = []

    def record(Vel, W0, old, fv, **kw):
        calls.append((Vel, W0, ps.SolverMap(*(getattr(old, f) for f in
                                              ps.SolverMap._fields)),
                      fv, kw))
        return ps.minimizer_rv(Vel, W0, old, fv, **kw)

    fe = VOFrontend(p, device="cuda")
    gf = torch.as_tensor(frames[:N_K3_LANES + 1], device=dev)
    step_mod.minimizer_rv, orig = record, step_mod.minimizer_rv
    try:
        st = fe.bootstrap(fe.init(), gf[0], 0.0)
        for i in range(1, N_K3_LANES + 1):
            st, _ = fe.step(st, gf[i], i / p.config_fps)
    finally:
        step_mod.minimizer_rv = orig
    torch.cuda.synchronize()
    launches0 = ps.minimizer_rv.launches
    cases = []
    for Vel, W0, old, fv, kw in calls:
        cases.append(compare_pose(ps.minimizer_rv(Vel, W0, old, fv, **kw),
                                  ps.minimizer_rv_plain(Vel, W0, old, fv,
                                                        **kw)))
    # the 16 calls as 16 lanes of one vmapped call: one launch
    kw0 = {k: v for k, v in calls[0][4].items()
           if k not in ("max_s_rho", "match_num_min", "vote_mask")}
    lanes = [torch.stack(x) for x in zip(*[
        (c[0], c[1], *c[2], c[3].ikl, c[3].attrs, c[4]["max_s_rho"],
         c[4]["match_num_min"]) for c in calls])]

    def batched(solver):
        def one(v, w, *rest):
            f = rest[:len(ps.SolverMap._fields)]
            ik, at, msr, mnm = rest[len(f):]
            return tuple(solver(v, w, ps.SolverMap(*f), ps.FieldView(ik, at),
                                max_s_rho=msr, match_num_min=mnm, **kw0))
        return lambda: torch.func.vmap(one)(*lanes)

    run_k16, run_p16 = batched(ps.minimizer_rv), batched(ps.minimizer_rv_plain)
    bk = ps.MinimizerRVResult(*run_k16())
    bp = ps.MinimizerRVResult(*run_p16())
    lanes16 = compare_pose(bk, bp)
    launches = ps.minimizer_rv.launches - launches0
    ok = (all(c["ok"] for c in cases) and lanes16["ok"]
          and launches == N_K3_LANES + 1)

    Vel, W0, old, fv, kw = calls[-1]
    times = k3_times(lambda: ps.minimizer_rv(Vel, W0, old, fv, **kw),
                     lambda: ps.minimizer_rv_plain(Vel, W0, old, fv, **kw),
                     run_k16, run_p16)
    K = old.valid.shape[-1]
    n_eval = 1 + (1 + kw["iter_max"])
    if kw["init_type"] not in (0, 1):
        n_eval += 5 * (1 + kw["init_iter"])
    bytes_of = [k3_bytes(K, c[2].valid, c[4].get("vote_mask"), n_eval)
                for c in calls]
    k3 = k3_line("k3_check", ok, cases, lanes16, launches, K, n_eval,
                 bytes_of[-1], sum(bytes_of), int(old.valid.sum()), times,
                 info, "pose_lm", smi)
    return k3, ok


def k3v_phase(smi, vi_dir, info):
    """Phase 3d (module docstring). Returns (the 3-dof mode's numbers for
    the kernel list, ok)."""
    from rebvo_tpu_torch.frontend import step as step_mod
    from rebvo_tpu_torch.kernels import pose_solver as ps
    dev = torch.device("cuda")
    p = REBVOParameters().replace(ImuMode=2)
    items = list(DatasetSequence.euroc(
        vi_dir, with_imu=True, window_size=imu_window_size(p),
        time_desinc=p.TimeDesinc))[:K3V_FROM + N_K3V_LANES]
    fe = VOFrontend(p, device="cuda")
    umap = build_undistort_map(fe.cam, device="cuda")
    calls = []

    def record(Vel, old, fv, **kw):
        calls.append((Vel, ps.SolverMap(*(getattr(old, f) for f in
                                              ps.SolverMap._fields)),
                      fv, kw))
        return ps.minimizer_v(Vel, old, fv, **kw)

    def frame(i):
        return apply_undistort(umap, torch.as_tensor(items[i][1],
                                                     device=dev))
    step_mod.minimizer_v, orig = record, step_mod.minimizer_v
    try:
        st = fe.bootstrap(fe.init(), frame(0), items[0][0])
        for i in range(1, len(items)):
            win = ImuWindow(*[x.cuda() for x in items[i][2]])
            st, _ = fe.step_imu(st, frame(i), items[i][0], win)
    finally:
        step_mod.minimizer_v = orig
    torch.cuda.synchronize()
    calls = calls[K3V_FROM - 1:]
    launches0 = ps.minimizer_v.launches
    cases = [compare_pose(ps.minimizer_v(Vel, old, fv, **kw),
                          ps.minimizer_v_plain(Vel, old, fv, **kw),
                          K3V_EXACT, K3V_ULPS)
             for Vel, old, fv, kw in calls]
    # the 16 calls as 16 lanes of one vmapped call: one launch
    per_lane = ("max_s_rho", "match_num_min", "min_mod", "vote_mask")
    kw0 = {k: v for k, v in calls[0][3].items() if k not in per_lane}
    lanes = [torch.stack(x) for x in zip(*[
        (c[0], *c[1], c[2].ikl, c[2].attrs, c[3]["max_s_rho"],
         c[3]["match_num_min"], c[3]["min_mod"]) for c in calls])]

    def batched(solver):
        def one(v, *rest):
            f = rest[:len(ps.SolverMap._fields)]
            ik, at, msr, mnm, mm = rest[len(f):]
            return tuple(solver(v, ps.SolverMap(*f), ps.FieldView(ik, at),
                                max_s_rho=msr, match_num_min=mnm,
                                min_mod=mm, **kw0))
        return lambda: torch.func.vmap(one)(*lanes)

    run_k16, run_p16 = batched(ps.minimizer_v), batched(ps.minimizer_v_plain)
    lanes16 = compare_pose(ps.MinimizerVResult(*run_k16()),
                           ps.MinimizerVResult(*run_p16()), K3V_EXACT,
                           K3V_ULPS)
    launches = ps.minimizer_v.launches - launches0
    ok = (all(c["ok"] for c in cases) and lanes16["ok"]
          and launches == N_K3V_LANES + 1)

    Vel, old, fv, kw = calls[-1]
    times = k3_times(lambda: ps.minimizer_v(Vel, old, fv, **kw),
                     lambda: ps.minimizer_v_plain(Vel, old, fv, **kw),
                     run_k16, run_p16)
    K = old.valid.shape[-1]
    # the prior's, the start's and the 3 rungs' (1 + 2 each), the main run
    n_eval = 1 + 4 * (1 + ps.V_LADDER_ITERS) + (1 + kw["iter_max"])
    bytes_of = [k3_bytes(K, c[1].valid, c[3].get("vote_mask"), n_eval)
                for c in calls]
    k3v = k3_line("k3v_check", ok, cases, lanes16, launches, K, n_eval,
                  bytes_of[-1], sum(bytes_of), int(old.valid.sum()), times,
                  info, "pose_v", smi)
    return k3v, ok


# phase 3e: K4's bytes a slot at the least (kf_correct.cu's bound): the
# frame map's px, py, p_id, n_id, m_id_kf, m_id and valid (a byte), the
# keyframe map's px, py, p_id, n_id, m_id_f and valid, m_f and m_kf
K4_BYTES_PER_SLOT = 6 * 4 + 1 + 5 * 4 + 1 + 2 * 4


def k4_launch_config(K):
    """K4's shared bytes, threads and cluster at K slots a lane, and its
    resident clusters."""
    lib = cuda_build.library("kf_correct")
    intp = ctypes.POINTER(ctypes.c_int)
    lib.kf_correct_max_clusters.argtypes = [ctypes.c_int, intp]
    lib.kf_correct_max_clusters.restype = ctypes.c_int
    lib.kf_correct_launch_config.argtypes = [ctypes.c_int] + [intp] * 3
    lib.kf_correct_launch_config.restype = None
    cfg = [ctypes.c_int(0) for _ in range(3)]
    lib.kf_correct_launch_config(K, *[ctypes.byref(c) for c in cfg])
    nclu = ctypes.c_int(0)
    err = lib.kf_correct_max_clusters(K, ctypes.byref(nclu))
    return {"smem_bytes": cfg[0].value, "threads": cfg[1].value,
            "cluster": cfg[2].value, "clusters_per_lane": 2,
            "max_active_clusters": nclu.value,
            "max_active_clusters_err": err}


def k4_phase(smi, p, frames, info):
    """Phase 3e (module docstring). Returns (the kernel's numbers for the
    kernel list, ok)."""
    from rebvo_tpu_torch.frontend import kf_tracking as kft
    from rebvo_tpu_torch.frontend import step as step_mod
    dev = torch.device("cuda")
    calls = []

    def record(kf, klm, fv, Pose, Pos, *a, **kw):
        calls.append((kf, klm, Pose, Pos))
        return kft.track_keyframe(kf, klm, fv, Pose, Pos, *a, **kw)

    fe = VOFrontend(p, device="cuda")
    gf = torch.as_tensor(frames[:N_K4_LANES + 1], device=dev)
    step_mod.track_keyframe = record
    try:
        st = fe.bootstrap(fe.init(), gf[0], 0.0)
        for i in range(1, N_K4_LANES + 1):
            st, _ = fe.step(st, gf[i], i / p.config_fps)
    finally:
        step_mod.track_keyframe = kft.track_keyframe
    torch.cuda.synchronize()
    zfm = fe.cam.zfm
    kw = dict(dist_thresh=p.KFDistThresh, chain_steps=p.KFChainSteps,
              aug_iters=p.KFAugIters, min_baseline_px=p.KFMinBaselinePx)

    def compare(k, r):
        res = {"m_f_mismatch": int((k[0] != r[0]).sum()),
               "m_kf_mismatch": int((k[1] != r[1]).sum()),
               "fow_m": [int(k[2].sum()), int(r[2].sum())],
               "back_m": [int(k[3].sum()), int(r[3].sum())]}
        res["ok"] = all(bool(torch.equal(a, b)) for a, b in zip(k, r))
        return res

    launches0 = kft.correct_and_augment.launches
    cases = [compare(kft.correct_and_augment(*c, zfm, **kw),
                     kft.correct_and_augment_plain(*c, zfm, **kw))
             for c in calls]
    # the 16 calls as 16 lanes of one vmapped call: one launch
    lanes = [torch.utils._pytree.tree_map(lambda *x: torch.stack(x), *z)
             for z in zip(*calls)]

    def batched(fn):
        return lambda: torch.func.vmap(
            lambda *a: fn(*a, zfm, **kw))(*lanes)

    run_k16 = batched(kft.correct_and_augment)
    run_p16 = batched(kft.correct_and_augment_plain)
    lanes16 = compare(run_k16(), run_p16())
    launches = kft.correct_and_augment.launches - launches0
    # the calls whose baseline tests pass (backward, forward): those walk
    strong = [sum(bool(kft._scalars(*c, zfm, p.KFMinBaselinePx)[i])
                  for c in calls) for i in (2, 3)]
    ok = (all(c["ok"] for c in cases) and lanes16["ok"]
          and launches == N_K4_LANES + 1)

    # the kernel alone on the last call's inputs (and on all 16), the
    # plain body on the same, the wrapper call (scalars and kernel)
    def inputs(c):
        return (*kft._scalars(*c, zfm, p.KFMinBaselinePx),
                *kft._fields(c[1], c[0].klm))
    t1 = inputs(calls[-1])
    t16 = [torch.stack(x) for x in zip(*[inputs(c) for c in calls])]
    kkw = {k: v for k, v in kw.items() if k != "min_baseline_px"}
    kkw["zfm"] = float(zfm)
    launch = kft._launcher()
    stream = torch.cuda.current_stream().cuda_stream
    l2 = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    flush = l2.zero_

    def run_k():
        kft.kf_launch(launch, t1, stream, **kkw)

    def run_k16_only():
        kft.kf_launch(launch, t16, stream, **kkw)

    def run_p():
        kft._body_plain(*t1, **kkw)
    plain_a = device_ms(run_p, 3, flush)
    k_a = device_ms(run_k, 50, flush)
    k16_a = device_ms(run_k16_only, 20, flush)
    k_b = device_ms(run_k, 50, flush)
    k16_b = device_ms(run_k16_only, 20, flush)
    plain_b = device_ms(run_p, 3, flush)
    times = {"kernel_ms": statistics.median([k_a, k_b]),
             "kernel_ms_runs": [k_a, k_b],
             "kernel_ms_16": statistics.median([k16_a, k16_b]),
             "kernel_ms_16_runs": [k16_a, k16_b],
             "plain_ms": statistics.median([plain_a, plain_b]),
             "plain_ms_runs": [plain_a, plain_b],
             "plain_ms_16": device_ms(run_p16, 2, flush),
             "call_ms": time_cuda(
                 lambda: kft.correct_and_augment(*calls[-1], zfm, **kw),
                 100, flush)}
    K = calls[-1][1].K
    bw = H100_MEM_BYTES_PER_S
    bytes_call = K * K4_BYTES_PER_SLOT
    bound_ms = bytes_call / bw * 1e3
    bound16_ms = N_K4_LANES * bound_ms
    res = ptxas_resources(info["kf_correct"]["ptxas"], lambda e: "kf")
    emit({"phase": "k4_check", "ok": ok, "cases": cases,
          "lanes16": lanes16, "strong_calls_b_f": strong,
          "launches": launches,
          "expected_launches": N_K4_LANES + 1, "K": K,
          "bytes": bytes_call, "bound_ms": bound_ms,
          "bound_ms_16": bound16_ms,
          "bound_by": "bytes (latency-bound: 13 dependent gather rounds a "
                      "walk, 4 walks, 8 augment passes behind cluster "
                      "barriers)",
          **times, "x_bound": times["kernel_ms"] / bound_ms,
          "x_bound_16": times["kernel_ms_16"] / bound16_ms,
          "library_ms": None, "resources": res,
          **k4_launch_config(K), "card": smi,
          "timing": "as k1_check; kernel: kf_launch alone, plain: the "
                    "body's ops on the same inputs, call: the wrapper "
                    "(scalars and kernel), host gaps included; _16: 16 "
                    "lanes in one call"})
    k4 = {**{k: times[k] for k in ("kernel_ms", "kernel_ms_16", "call_ms",
                                   "plain_ms", "plain_ms_16")},
          "bound_ms": bound_ms, "bound_ms_16": bound16_ms,
          "x_bound": times["kernel_ms"] / bound_ms,
          "resources": res.get("kf"), "check_launches": launches}
    return k4, ok

# phase 3f: K5's bytes a slot at the least (match_depth.cu's bound):
# md_match reads the old map's 12 float fields, its valid (a byte) and 2
# int fields, m_id_f, the new map's 15 float fields, valid and 3 int
# fields, and writes 16 float and 3 int rows; md_depth reads 14 float
# fields, valid and 4 int fields and writes 4 float rows
K5_MATCH_BYTES_PER_SLOT = (12 * 4 + 1 + 2 * 4 + 4) + (15 * 4 + 1 + 3 * 4) \
    + 19 * 4
K5_DEPTH_BYTES_PER_SLOT = 14 * 4 + 1 + 4 * 4 + 4 * 4
N_K5_LANES = 16


@contextlib.contextmanager
def plain_stage():
    """The stage's plain versions on the card inside: md_match and
    md_depth run `match_plain` and `depth_plain` (lane by lane under
    vmap) and launch nothing of K5."""
    from rebvo_tpu_torch.kernels import match_depth as mdk
    ops = mdk._match_op, mdk._depth_op

    def plain(fn, dims):
        def run(*ts, **kw):
            lanes = tuple(ts[(4, 1)[fn is mdk.depth_plain]].shape[:-1])
            if not lanes:
                return fn(*ts, **kw)
            return mdk._per_lane(lambda *a: fn(*a, **kw), lanes, ts, dims)
        return run
    mdk._match_op = plain(mdk.match_plain, (1, 1, 0, 0, 0))
    mdk._depth_op = plain(mdk.depth_plain, (1, 0))
    try:
        yield
    finally:
        mdk._match_op, mdk._depth_op = ops


def k5_launch_config(K):
    """K5's shared bytes, threads and cluster at K slots a lane, and each
    kernel's resident clusters."""
    lib = cuda_build.library("match_depth")
    intp = ctypes.POINTER(ctypes.c_int)
    lib.md_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int, intp]
    lib.md_max_clusters.restype = ctypes.c_int
    lib.md_launch_config.argtypes = [ctypes.c_int] + [intp] * 4
    lib.md_launch_config.restype = None
    cfg = [ctypes.c_int(0) for _ in range(4)]
    lib.md_launch_config(K, *[ctypes.byref(c) for c in cfg])
    out = {"smem_bytes_match": cfg[0].value, "smem_bytes_depth": cfg[1].value,
           "threads": cfg[2].value, "cluster": cfg[3].value,
           "clusters_per_lane": 1}
    for depth, key in ((0, "match"), (1, "depth")):
        n = ctypes.c_int(0)
        err = lib.md_max_clusters(depth, K, ctypes.byref(n))
        out[f"max_active_clusters_{key}"] = n.value
        out[f"max_active_clusters_{key}_err"] = err
    return out


def k5_phase(smi, p, frames, info):
    """Phase 3f (module docstring). Returns (the kernels' numbers for the
    kernel list, ok)."""
    from rebvo_tpu_torch.frontend import step as step_mod
    from rebvo_tpu_torch.kernels import match_depth as mdk
    dev = torch.device("cuda")
    calls = []
    orig = step_mod.md_match, step_mod.md_depth

    def rec_m(*a, **kw):
        calls.append([mdk.match_args(*a, **kw)])
        return orig[0](*a, **kw)

    def rec_d(*a, **kw):
        calls[-1].append(mdk.depth_args(*a, **kw))
        return orig[1](*a, **kw)

    fe = VOFrontend(p, device="cuda")
    gf = torch.as_tensor(frames[:N_K5_LANES + 1], device=dev)
    step_mod.md_match, step_mod.md_depth = rec_m, rec_d
    try:
        st = fe.bootstrap(fe.init(), gf[0], 0.0)
        for i in range(1, N_K5_LANES + 1):
            st, _ = fe.step(st, gf[i], i / p.config_fps)
    finally:
        step_mod.md_match, step_mod.md_depth = orig
    torch.cuda.synchronize()

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    def compare(k, r):
        res = {"mismatch": [int((bits(a) != bits(b)).sum())
                            for a, b in zip(k, r)]}
        res["ok"] = not any(res["mismatch"])
        return res

    def vmapped(fn, stacked, kw):
        dims = tuple(None if x is None else 0 for x in stacked)
        return torch.func.vmap(lambda *a: fn(*a, **kw), in_dims=dims)(
            *stacked)

    def stack(items):
        return [None if x[0] is None else
                [torch.stack(y) for y in zip(*x)]
                if isinstance(x[0], list) else torch.stack(x)
                for x in zip(*items)]

    m0, d0 = mdk.md_match.launches, mdk.md_depth.launches
    cases = []
    for (mts, mkw), (dts, dkw) in calls:
        cm = compare(mdk._match_op(*mts, **mkw), mdk.match_plain(*mts, **mkw))
        cd = compare(mdk._depth_op(*dts, **dkw), mdk.depth_plain(*dts, **dkw))
        cases.append({"match": cm, "depth": cd,
                      "nmatch": int(mdk.match_plain(*mts, **mkw)[3])})
    (mts, mkw), (dts, dkw) = calls[-1]
    mst = stack([c[0][0] for c in calls])
    dst = stack([c[1][0] for c in calls])
    lanes16 = {"match": compare(vmapped(mdk._match_op, mst, mkw),
                                vmapped(mdk.match_plain, mst, mkw)),
               "depth": compare(vmapped(mdk._depth_op, dst, dkw),
                                vmapped(mdk.depth_plain, dst, dkw))}
    launches = (mdk.md_match.launches - m0, mdk.md_depth.launches - d0)
    ok = (all(c["match"]["ok"] and c["depth"]["ok"] for c in cases)
          and lanes16["match"]["ok"] and lanes16["depth"]["ok"]
          and launches == (N_K5_LANES + 1, N_K5_LANES + 1))

    # the kernels alone on the last call's inputs (and on all 16), the
    # plain versions on the same, the wrappers' calls
    launch_m, launch_d = mdk._launchers()
    stream = torch.cuda.current_stream().cuda_stream
    l2 = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    flush = l2.zero_

    def run_k():
        mdk.match_launch(launch_m, *mts, stream, **mkw)
        mdk.depth_launch(launch_d, *dts, stream, **dkw)

    def run_k16():
        mdk.match_launch(launch_m, *mst, stream, **mkw)
        mdk.depth_launch(launch_d, *dst, stream, **dkw)

    def run_p():
        mdk.match_plain(*mts, **mkw)
        mdk.depth_plain(*dts, **dkw)

    def run_p16():
        vmapped(mdk.match_plain, mst, mkw)
        vmapped(mdk.depth_plain, dst, dkw)

    def run_call():
        mdk._match_op(*mts, **mkw)
        mdk._depth_op(*dts, **dkw)
    plain_a = device_ms(run_p, 3, flush)
    k_a = device_ms(run_k, 50, flush)
    k16_a = device_ms(run_k16, 20, flush)
    km_a = device_ms(lambda: mdk.match_launch(launch_m, *mts, stream, **mkw),
                     50, flush)
    k_b = device_ms(run_k, 50, flush)
    k16_b = device_ms(run_k16, 20, flush)
    plain_b = device_ms(run_p, 3, flush)
    times = {"kernel_ms": statistics.median([k_a, k_b]),
             "kernel_ms_runs": [k_a, k_b], "md_match_ms": km_a,
             "kernel_ms_16": statistics.median([k16_a, k16_b]),
             "kernel_ms_16_runs": [k16_a, k16_b],
             "plain_ms": statistics.median([plain_a, plain_b]),
             "plain_ms_runs": [plain_a, plain_b],
             "plain_ms_16": device_ms(run_p16, 2, flush),
             "call_ms": time_cuda(run_call, 100, flush)}
    del l2
    K = mts[0][0].shape[-1]
    bytes_call = K * (K5_MATCH_BYTES_PER_SLOT + K5_DEPTH_BYTES_PER_SLOT)
    bound_ms = bytes_call / H100_MEM_BYTES_PER_S * 1e3
    bound16_ms = N_K5_LANES * bound_ms
    res = ptxas_resources(info["match_depth"]["ptxas"],
                          lambda e: "md_depth" if "depth" in e
                          else "md_match")
    emit({"phase": "k5_check", "ok": ok, "cases": cases,
          "lanes16": lanes16, "launches": list(launches),
          "expected_launches": N_K5_LANES + 1, "K": K,
          "bytes": bytes_call, "bound_ms": bound_ms,
          "bound_ms_16": bound16_ms,
          "bound_by": "bytes (latency-bound: a slot's dependent gathers, "
                      "md_depth's 5 cluster-wide float64 reductions)",
          **times, "x_bound": times["kernel_ms"] / bound_ms,
          "x_bound_16": times["kernel_ms_16"] / bound16_ms,
          "library_ms": None, "resources": res,
          **k5_launch_config(K), "card": smi,
          "timing": "as k1_check; kernel: md_match then md_depth by their "
                    "launchers alone, plain: the plain versions' ops on "
                    "the same inputs, call: both ops (the wrappers' "
                    "launch paths), host gaps included; _16: 16 lanes in "
                    "one call each"})
    k5 = {**{k: times[k] for k in ("kernel_ms", "kernel_ms_16", "call_ms",
                                   "plain_ms", "plain_ms_16",
                                   "md_match_ms")},
          "bound_ms": bound_ms, "bound_ms_16": bound16_ms,
          "x_bound": times["kernel_ms"] / bound_ms, "resources": res,
          "check_launches": list(launches)}
    return k5, ok


def profile_steps(fe, state, frames, ts, step=None, extra=None,
                  table="profile.txt"):
    """Step through `frames` under torch.profiler with `step` (default
    fe.step; `extra[i]` holds step i's further arguments). Per step: the
    device activities and their busy ms, K1's device ms, and per stage
    span its activities, busy ms and device-side range (under the
    profiler, so stretched by its host overhead); the PyTorch ops with
    the most device time. The full table goes to chiprun_out/smoke/
    `table`."""
    from torch.autograd import DeviceType
    n = len(frames)
    step = step or fe.step
    extra = extra or [()] * n
    out = []

    def run():
        st = state
        for f, t, e in zip(frames, ts, extra):
            st, _ = step(st, f, t, *e)
        out.append(st)
    t0 = time.perf_counter()
    prof = _profiled(run)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
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
    with open(os.path.join(OUT, table), "w") as fh:
        fh.write(avg.table(sort_by="self_device_time_total", row_limit=60))
    return out[0], {
        "steps": n, "wall_ms_per_step_profiled": wall_ms,
        "trace_processing_s": time.perf_counter() - t0,
        "device_activities_per_step": len(acts) / n,
        "device_busy_ms_per_step": sum(a[1] - a[0] for a in acts) / 1e3 / n,
        "k1_ms_per_step": sum(a[1] - a[0] for a in acts
                              if "detect_kernel" in a[2]) / 1e3 / n,
        "spans": spans, "top_ops": top}


def write_fixture():
    """The EuRoC directory phases 10 and 11 share: N_VI + N_VI_PROFILE
    frames of cam0 and cam1 and their 200 Hz IMU, at the default config
    (write_euroc_vi). Returns (directory, cam0 positions, seconds)."""
    vi_dir = os.path.join(OUT, "euroc_vi")
    shutil.rmtree(vi_dir, ignore_errors=True)
    t0 = time.perf_counter()
    _, pos_true = write_euroc_vi(REBVOParameters(), N_VI + N_VI_PROFILE,
                                 vi_dir, workers=8, stereo=True)
    return vi_dir, pos_true, time.perf_counter() - t0


def vi_path(smi, vi_dir, pos_true, write_s):
    """Phases 10-10d: the visual-inertial EuRoC path at the default
    config with ImuMode=2. Returns ({path: launch counts}, ok)."""
    p = REBVOParameters().replace(ImuMode=2)
    on = 5 + p.InitBiasFrameNum          # the scale filter's first step
    t0 = time.perf_counter()
    items = list(DatasetSequence.euroc(
        vi_dir, with_imu=True, window_size=imu_window_size(p),
        time_desinc=p.TimeDesinc))
    read_s = time.perf_counter() - t0
    ts = [t for t, _, _ in items]
    frames = [torch.as_tensor(f, device="cuda") for _, f, _ in items]
    wins = [ImuWindow(*[x.cuda() for x in w]) for _, _, w in items]

    # ---- 10. the VI path ----------------------------------------------
    fe = VOFrontend(p, device="cuda")
    umap = build_undistort_map(fe.cam, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    kc0 = obs.counters().get("pose_v.kernel", 0)
    kf0 = obs.counters().get("kf.kernel", 0)
    md0 = [obs.counters().get(k, 0) for k in ("md.match", "md.depth")]
    state = fe.bootstrap(fe.init(), apply_undistort(umap, frames[0]), ts[0])
    outs, step_ms, und_ev, pre = [], [], [], {}
    for i in range(1, N_VI):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if i > 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            if on <= i < N_VI_CPU:           # phase 10d's start states
                pre[i] = clone_tree(state)
            if i == N_VI - N_VI_SCAN:        # phase 10e's start state
                scan0 = clone_tree(state)
            a.record()
            f = apply_undistort(umap, frames[i])
            b.record()
            t0 = time.perf_counter()
            state, out = fe.step_imu_donated(state, f, ts[i], wins[i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        und_ev.append((a, b))
        outs.append(out)
    vi_launches = read_launches()
    # K3's 3-dof mode: one launch a VI step, and its counter with it
    k3v_main = (vi_launches["minimizer_v"],
                obs.counters().get("pose_v.kernel", 0) - kc0)
    # K4: one launch a VI step, and its counter with it
    k4_main = (vi_launches["correct_and_augment"],
               obs.counters().get("kf.kernel", 0) - kf0)
    # K5: each kernel once a VI step (md_match without the transfer)
    k5_main = (vi_launches["md_match"], vi_launches["md_depth"],
               *[obs.counters().get(k, 0) - c for k, c in
                 zip(("md.match", "md.depth"), md0)])
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    und_ms = statistics.median(a.elapsed_time(b) for a, b in und_ev)
    pos = np.stack([o.nav.Pos.cpu().numpy() for o in outs])
    kl = [int(o.nav.kl_num) for o in outs]
    est = [bool(o.nav.estimation_ok) for o in outs]
    est_share = float(np.mean(est[2:]))
    g = state.imu.g_est.cpu().numpy().astype(np.float64)
    gn = g / np.linalg.norm(g)
    # test_vi_step's bar: the unit g_est's component along the true down
    # direction above 0.95, i.e. 1 - cos(angle) <= 0.05
    g_dir_err = float(1.0 - gn @ G_DOWN)
    K = float(state.K_scale)
    Ks = [float(o.nav.scale) for o in outs]
    k1 = vi_launches["detect_candidates_cuda"]
    finite = bool(np.all(np.isfinite(pos)))
    # the trajectory against the written path over the frames the scale
    # filter drives: similarity-aligned (its shape) and rigidly aligned
    # (its metric scale, which K sets)
    est_on, true_on = pos[on - 1:], pos_true[on:N_VI]
    extent = float(np.ptp(true_on, axis=0).max())
    ate = ate_rmse(est_on, true_on, with_scale=True)
    ate_metric = ate_rmse(est_on, true_on, with_scale=False)
    scale = align_umeyama(est_on, true_on)[0]
    # K strictly inside the filter's clamp [1e-2, 1e3] and below
    # test_vi_step's 100 on every filtered frame, and settled at the end;
    # the trajectory near the written path's shape and metric scale. The
    # first fixture's collapse (K at 1e-2) failed these: ATE 0.0897 m
    # over the 0.3 m extent, similarity-aligned.
    k_in_band = all(VI_K_FLOOR < k < VI_K_CEIL for k in Ks[on - 1:])
    k_settle = max(abs(k / K - 1.0) for k in Ks[-10:])
    ok10 = (finite and min(kl) >= KL_FLOOR and est_share >= 0.9
            and g_dir_err <= 0.05 and abs(np.linalg.norm(g) - 9.8) < 0.5
            and k_in_band and k_settle <= VI_K_SETTLED
            and ate <= VI_ATE_SHAPE * extent
            and ate_metric <= VI_ATE_METRIC * extent
            and VI_SCALE_BAND[0] < scale < VI_SCALE_BAND[1] and k1 == N_VI
            and k3v_main == (N_VI - 1, N_VI - 1)
            and k4_main == (N_VI - 1, N_VI - 1)
            and k5_main == (N_VI - 1,) * 4
            and vi_launches["minimizer_rv"] == 0)
    steady = step_ms[5:]
    np.savez(os.path.join(OUT, "vi_path.npz"), pos=pos, kl=kl, est=est,
             step_ms=step_ms, g=g, K=Ks, pos_true=pos_true)
    emit({"phase": "vi_main", "ok": ok10, "frames": N_VI,
          "launches": vi_launches, "k1_launches": k1,
          "k1_launches_expected": N_VI,
          "k3v_launches_and_counter": list(k3v_main),
          "k4_launches_and_counter": list(k4_main),
          "k5_launches_and_counters": list(k5_main),
          "k3v_launches_expected": N_VI - 1, "kl_min": min(kl),
          "kl_floor": KL_FLOOR, "est_ok_share_after_2": est_share,
          "g_est": g.tolist(), "g_norm": float(np.linalg.norm(g)),
          "g_dir": gn.tolist(), "g_dir_err": g_dir_err,
          "g_angle_deg": float(np.degrees(np.arccos(min(gn @ G_DOWN,
                                                        1.0)))),
          "K_scale": K, "K_per_frame": Ks, "K_in_band": k_in_band,
          "K_band": [VI_K_FLOOR, VI_K_CEIL], "K_settle_last10": k_settle,
          "ate_vs_path": ate, "ate_vs_path_metric": ate_metric,
          "scale_vs_path": scale, "scale_band": VI_SCALE_BAND,
          "path_extent": extent,
          "ate_bars": [VI_ATE_SHAPE * extent, VI_ATE_METRIC * extent],
          "pos_finite": finite,
          "ms_per_frame_median": statistics.median(steady),
          "ms_per_frame_min": min(steady), "warmup_frames": 5,
          "undistort_ms_median": und_ms, "write_s": write_s,
          "read_s": read_s,
          "timing": "host clock around step_imu_donated + synchronize; "
                    "undistort: CUDA events around apply_undistort",
          "peak_device_mb": peak_mb, "card": smi})
    if not ok10:
        return {"vi_main": vi_launches}, False

    # ---- 10e. the VI graph against the eager VI steps -------------------
    sc = range(N_VI - N_VI_SCAN, N_VI)
    sc_f = torch.stack([apply_undistort(umap, frames[i]) for i in sc])
    sc_t = torch.tensor([ts[i] for i in sc], dtype=torch.float32,
                        device="cuda")
    st = clone_tree(scan0)
    ref = []
    for k, i in enumerate(sc):
        st, out = fe.step_imu_donated(st, sc_f[k], sc_t[k], wins[i],
                                      fe.R_cam2imu, fe.T_cam2imu)
        ref.append(out)
    ref_state = st
    # the same frames through eager steps with the stage's plain versions
    st, ref_plain = clone_tree(scan0), []
    with plain_stage():
        for k, i in enumerate(sc):
            st, out = fe.step_imu_donated(st, sc_f[k], sc_t[k], wins[i],
                                          fe.R_cam2imu, fe.T_cam2imu)
            ref_plain.append(out)
    ref_plain_state = st
    chunks = [slice(c, c + VI_SCAN_N) for c in range(0, N_VI_SCAN, VI_SCAN_N)]
    host_w = [stack_windows([items[i][2] for i in sc[c]]) for c in chunks]
    c0 = obs.counters()
    fe.step_scan(clone_tree(scan0), sc_f[chunks[0]], sc_t[chunks[0]],
                 host_w[0])                            # the capture
    c1 = obs.counters()
    dev_w = [ImuWindow(*[x.cuda() for x in w]) for w in host_w]
    torch.cuda.synchronize()
    zero_launches()
    st, souts = clone_tree(scan0), []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c, w in zip(chunks, dev_w):
            st, out = fe.step_scan(st, sc_f[c], sc_t[c], w)
            souts.append(out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    scan_launches = read_launches()
    c2 = obs.counters()

    def delta(a, b, name):
        return b.get(name, 0) - a.get(name, 0)
    differing = leaves_differing
    ref_outs = [torch.stack(xs)
                for xs in zip(*[tree_leaves(o) for o in ref])]
    scan_outs = [torch.cat(xs)
                 for xs in zip(*[tree_leaves(o) for o in souts])]
    n_rep = len(chunks)
    d_state = differing(st, ref_state)
    d_outs = differing(scan_outs, ref_outs)
    d_plain = [differing(st, ref_plain_state), differing(scan_outs, [
        torch.stack(xs) for xs in zip(*[tree_leaves(o) for o in ref_plain])])]
    k1_per = scan_launches["detect_candidates_cuda"] / n_rep
    k3 = scan_launches["minimizer_rv"]
    k3v_per = scan_launches["minimizer_v"] / n_rep
    k4_per = scan_launches["correct_and_augment"] / n_rep
    k5_per = [scan_launches["md_match"] / n_rep,
              scan_launches["md_depth"] / n_rep]
    samples = int(host_w[0].count.sum())      # the capture's windows
    counts = {"graph.captures": delta(c0, c1, "graph.captures"),
              "graph.replays": delta(c1, c2, "graph.replays"),
              "imu.samples": delta(c0, c1, "imu.samples"),
              "imu.truncated": delta(c0, c1, "imu.truncated"),
              "pose_v.kernel": delta(c0, c1, "pose_v.kernel"),
              "pose_v.kernel_replays": delta(c1, c2, "pose_v.kernel"),
              "kf.kernel": delta(c0, c1, "kf.kernel"),
              "kf.kernel_replays": delta(c1, c2, "kf.kernel"),
              **{k + s: delta(*ab, k) for k in ("md.match", "md.depth")
                 for s, ab in (("", (c0, c1)), ("_replays", (c1, c2)))}}
    # the capture counts the warm-up's two steps and the captured ones
    ok10e = (d_state == 0 and d_outs == 0 and d_plain == [0, 0]
             and k1_per == VI_SCAN_N and k5_per == [VI_SCAN_N] * 2
             and all(counts[k] == 2 + VI_SCAN_N and counts[k + "_replays"]
                     == 0 for k in ("md.match", "md.depth"))
             and k3 == 0 and k3v_per == VI_SCAN_N and k4_per == VI_SCAN_N
             and counts["pose_v.kernel"] == 2 + VI_SCAN_N
             and counts["pose_v.kernel_replays"] == 0
             and counts["kf.kernel"] == 2 + VI_SCAN_N
             and counts["kf.kernel_replays"] == 0
             and counts["graph.captures"] == 1
             and counts["graph.replays"] == n_rep
             and counts["imu.samples"] == samples
             and counts["imu.truncated"] == 0)
    emit({"phase": "vi_scan", "ok": ok10e, "frames": N_VI_SCAN,
          "from_frame": sc[0], "chunk": VI_SCAN_N, "replays": n_rep,
          "K_scale_start": float(scan0.K_scale),
          "state_leaves_differing": d_state,
          "output_leaves_differing": d_outs,
          "state_output_leaves_differing_plain_stage": d_plain,
          "launches": scan_launches,
          "k1_launches_per_replay": k1_per, "k3_launches": k3,
          "k3v_launches_per_replay": k3v_per,
          "k4_launches_per_replay": k4_per,
          "k5_launches_per_replay": k5_per,
          "counters": counts, "imu_samples_expected": samples,
          "compare": "bit for bit, NaN equal to NaN", "card": smi})
    if not ok10e:
        return {"vi_main": vi_launches, "vi_scan": scan_launches}, False

    # ---- 10b. where the VI step's time goes -----------------------------
    pf = [apply_undistort(umap, f) for f in frames[N_VI:]]
    _, prof = profile_steps(fe, state, pf, ts[N_VI:], step=fe.step_imu,
                            extra=[(w,) for w in wins[N_VI:]],
                            table="profile_vi.txt")
    busy = prof["device_busy_ms_per_step"]
    emit({"phase": "vi_profile", **prof,
          "device_idle_share": 1.0 - busy / statistics.median(steady),
          "idle_share_of": "median unprofiled ms/frame of phase 10",
          "card": smi})

    # ---- 10c. run_vo --euroc --imu on the card --------------------------
    from rebvo_tpu_torch.apps import run_vo
    zero_launches()
    rv_dir = os.path.join(OUT, "vi_run_vo")
    cfg = os.path.join(OUT, "vi_run_vo.cfg")
    save_config(p, cfg)
    run_vo.main(["--euroc", vi_dir, "--imu", "--max-frames", str(N_VI),
                 "--out-dir", rv_dir, "--config", cfg])
    rv_launches = read_launches()
    tum = np.loadtxt(os.path.join(rv_dir, p.TrayFile))
    tol = pos_tolerance(pos)
    dpos = float(np.abs(tum[:, 1:4] - pos).max()) \
        if tum.shape[0] == pos.shape[0] else float("inf")
    ok10c = (tum.shape[0] == N_VI - 1 and bool(np.all(np.isfinite(tum)))
             and dpos <= tol and rv_launches["detect_candidates_cuda"] == N_VI)
    emit({"phase": "vi_run_vo", "ok": ok10c, "tum_rows": int(tum.shape[0]),
          "expected_rows": N_VI - 1, "max_abs_pos_diff": dpos,
          "tolerance": tol, "launches": rv_launches})
    if not ok10c:
        return {"vi_main": vi_launches, "vi_scan": scan_launches,
                "vi_run_vo": rv_launches}, False

    # ---- 10d. the first VI frames on the CPU, past the filter's start ---
    # The sequence: kl_num equal on every frame, Pos within phase 7's bar
    # before the filter's start. After it the two runs part as float32
    # sum-order noise grows through the filter (ROADMAP queue 3): their
    # gaps are reported, and the card's filter is held instead by one CPU
    # step from the card's own state at each filtered frame.
    fe_cpu = VOFrontend(p, device="cpu")
    umap_cpu = build_undistort_map(fe_cpu.cam, device="cpu")
    cpu_frames = [apply_undistort(umap_cpu, f.cpu())
                  for f in frames[:N_VI_CPU]]
    st = fe_cpu.bootstrap(fe_cpu.init(), cpu_frames[0], ts[0])
    cpu = []
    for i in range(1, N_VI_CPU):
        st, out = fe_cpu.step_imu(st, cpu_frames[i], ts[i], items[i][2])
        cpu.append(out)
    card = outs[:N_VI_CPU - 1]
    single = {i: fe_cpu.step_imu(map_tree(lambda x: x.cpu(), pre[i]),
                                 cpu_frames[i], ts[i], items[i][2])[1]
              for i in sorted(pre)}

    def gap(field, pairs):
        return float(max(np.abs(getattr(a.nav, field).numpy() -
                                getattr(b.nav, field).cpu().numpy()).max()
                         for a, b in pairs))

    def k_gap(pairs):
        return float(max(abs(float(a.nav.scale) / float(b.nav.scale) - 1.0)
                         for a, b in pairs))
    cpu_kl = [int(o.nav.kl_num) for o in cpu]
    n_off = on - 1                         # steps before the filter's start
    off = list(zip(cpu[:n_off], card[:n_off]))
    seq = list(zip(cpu[n_off:], card[n_off:]))
    one = [(single[i], outs[i - 1]) for i in sorted(single)]
    tol = pos_tolerance(np.stack([o.nav.Pos.numpy() for o in cpu[:n_off]]))
    dpos = gap("Pos", off)
    k_one, g_one, pos_one = k_gap(one), gap("g", one), gap("Pos", one)
    ok10d = (cpu_kl == kl[:N_VI_CPU - 1] and dpos <= tol
             and len(one) == N_VI_CPU - on
             and k_one <= VI_CPU_K_RTOL and g_one <= VI_CPU_G_ATOL
             and pos_one <= VI_CPU_POS_ATOL)
    emit({"phase": "vi_cpu", "ok": ok10d, "frames": N_VI_CPU,
          "kl_cpu": cpu_kl, "kl_card": kl[:N_VI_CPU - 1],
          "max_abs_pos_diff_before_filter": dpos, "tolerance": tol,
          "single_steps": sorted(single),
          "single_K_cpu": [float(a.nav.scale) for a, _ in one],
          "single_K_card": [float(b.nav.scale) for _, b in one],
          "single_max_rel_K_diff": k_one, "K_rtol": VI_CPU_K_RTOL,
          "single_max_abs_g_diff": g_one, "g_atol": VI_CPU_G_ATOL,
          "single_max_abs_pos_diff": pos_one, "pos_atol": VI_CPU_POS_ATOL,
          "single_max_abs_vel_diff": gap("Vel", one),
          "seq_K_cpu": [float(a.nav.scale) for a, _ in seq],
          "seq_K_card": [float(b.nav.scale) for _, b in seq],
          "seq_max_rel_K_diff": k_gap(seq),
          "seq_max_abs_g_diff": gap("g", seq),
          "seq_max_abs_pos_diff": gap("Pos", seq),
          "seq_max_abs_vel_diff": gap("Vel", seq)})
    return {"vi_main": vi_launches, "vi_scan": scan_launches,
            "vi_run_vo": rv_launches}, ok10d


def _tum_rows(path):
    tum = np.loadtxt(path, ndmin=2)
    return tum, tum[:, 1:4]


def stereo_scan_phase(smi, fe, scan0, um0, um1, f0, f1, ts):
    """Phase 11f: phase 11's last N_ST_SCAN frames from its state before
    them (`scan0`) as replays of step_scan's stereo graph (N = ST_SCAN_N,
    cam1's frames as frames_pair) under sync-debug "error", bit for bit
    against the same frames through eager step_donated with the pair.
    Returns (the replays' launches, ok)."""
    sc = range(N_ST - N_ST_SCAN, N_ST)
    sc_f = torch.stack([apply_undistort(um0, f0[i]) for i in sc])
    sc_p = torch.stack([apply_undistort(um1, f1[i]) for i in sc])
    sc_t = torch.tensor([ts[i] for i in sc], dtype=torch.float32,
                        device="cuda")
    st = clone_tree(scan0)
    ref = []
    for k in range(N_ST_SCAN):
        st, out = fe.step_donated(st, sc_f[k], sc_t[k], sc_p[k])
        ref.append(out)
    ref_state = st
    # the same frames through eager steps with the stage's plain versions
    st, ref_plain = clone_tree(scan0), []
    with plain_stage():
        for k in range(N_ST_SCAN):
            st, out = fe.step_donated(st, sc_f[k], sc_t[k], sc_p[k])
            ref_plain.append(out)
    ref_plain_state = st
    chunks = [slice(c, c + ST_SCAN_N) for c in range(0, N_ST_SCAN, ST_SCAN_N)]
    c0 = obs.counters()
    fe.step_scan(clone_tree(scan0), sc_f[chunks[0]], sc_t[chunks[0]],
                 frames_pair=sc_p[chunks[0]])          # the capture
    c1 = obs.counters()
    torch.cuda.synchronize()
    zero_launches()
    st, souts = clone_tree(scan0), []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in chunks:
            st, out = fe.step_scan(st, sc_f[c], sc_t[c], frames_pair=sc_p[c])
            souts.append(out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = read_launches()
    c2 = obs.counters()

    def delta(a, b, name):
        return b.get(name, 0) - a.get(name, 0)
    ref_outs = [torch.stack(xs)
                for xs in zip(*[tree_leaves(o) for o in ref])]
    scan_outs = [torch.cat(xs)
                 for xs in zip(*[tree_leaves(o) for o in souts])]
    n_rep = len(chunks)
    d_state = leaves_differing(st, ref_state)
    d_outs = leaves_differing(scan_outs, ref_outs)
    d_plain = [leaves_differing(st, ref_plain_state),
               leaves_differing(scan_outs, [
                   torch.stack(xs)
                   for xs in zip(*[tree_leaves(o) for o in ref_plain])])]
    k1_per = launches["detect_candidates_cuda"] / n_rep
    k3_per = launches["minimizer_rv"] / n_rep
    k4_per = launches["correct_and_augment"] / n_rep
    k5_per = [launches["md_match"] / n_rep, launches["md_depth"] / n_rep]
    counts = {"graph.captures": delta(c0, c1, "graph.captures"),
              "graph.replays": delta(c1, c2, "graph.replays"),
              "stereo.pairs": delta(c0, c2, "stereo.pairs"),
              "stereo.unpaired": delta(c0, c2, "stereo.unpaired"),
              "pose.kernel": delta(c0, c1, "pose.kernel"),
              "pose.kernel_replays": delta(c1, c2, "pose.kernel"),
              "kf.kernel": delta(c0, c1, "kf.kernel"),
              "kf.kernel_replays": delta(c1, c2, "kf.kernel"),
              **{k + s: delta(*ab, k) for k in ("md.match", "md.depth")
                 for s, ab in (("", (c0, c1)), ("_replays", (c1, c2)))}}
    stages = {r.name for r in obs.records() if r.device_ms is not None
              and r.frame >= fe.frame_id - N_ST_SCAN}
    # the capture counts the warm-up's two steps and the captured ones
    ok = (d_state == 0 and d_outs == 0 and d_plain == [0, 0]
          and k5_per == [ST_SCAN_N] * 2
          and all(counts[k] == 2 + ST_SCAN_N and counts[k + "_replays"]
                  == 0 for k in ("md.match", "md.depth"))
          and k1_per == 2 * ST_SCAN_N
          and k3_per == ST_SCAN_N and k4_per == ST_SCAN_N
          and launches["minimizer_v"] == 0
          and counts["pose.kernel"] == 2 + ST_SCAN_N
          and counts["pose.kernel_replays"] == 0
          and counts["kf.kernel"] == 2 + ST_SCAN_N
          and counts["kf.kernel_replays"] == 0
          and counts["graph.captures"] == 1
          and counts["graph.replays"] == n_rep
          and counts["stereo.pairs"] == ST_SCAN_N + N_ST_SCAN
          and counts["stereo.unpaired"] == 0
          and "vo.stereo" in stages)
    emit({"phase": "stereo_scan", "ok": ok, "frames": N_ST_SCAN,
          "from_frame": sc[0], "chunk": ST_SCAN_N, "replays": n_rep,
          "VScaleC_start": float(scan0.VScaleC),
          "state_leaves_differing": d_state,
          "output_leaves_differing": d_outs, "launches": launches,
          "k1_launches_per_replay": k1_per,
          "k3_launches_per_replay": k3_per,
          "k4_launches_per_replay": k4_per,
          "k5_launches_per_replay": k5_per,
          "state_output_leaves_differing_plain_stage": d_plain,
          "counters": counts, "stages_timed": sorted(stages),
          "compare": "bit for bit, NaN equal to NaN", "card": smi})
    return launches, ok


def stereo_path(smi, st_dir, pos_true):
    """Phases 11-11d: the stereo EuRoC path at the default config with
    StereoAvaiable=1, on phase 10's directory (cam0 + cam1). Returns
    ({path: launch counts}, ok)."""
    from rebvo_tpu_torch.io.logger import read_mfile
    p = REBVOParameters().replace(StereoAvaiable=1)
    move = p.InitBiasFrameNum + 2          # the path's first moving frame
    t0 = time.perf_counter()
    items = list(DatasetSequence.euroc(st_dir, with_imu=False, stereo=True))
    read_s = time.perf_counter() - t0
    ts = [t for t, _, _, _ in items]
    f0 = [torch.as_tensor(f, device="cuda") for _, f, _, _ in items]
    f1 = [torch.as_tensor(g, device="cuda") for _, _, _, g in items]

    # ---- 11. the stereo path -------------------------------------------
    fe = VOFrontend(p, device="cuda")
    um0 = build_undistort_map(fe.cam, device="cuda")
    um1 = build_undistort_map(fe.cam_pair, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    state = fe.bootstrap(fe.init(), apply_undistort(um0, f0[0]), ts[0],
                         apply_undistort(um1, f1[0]))
    outs, kl_pair, step_ms = [], [], []
    for i in range(1, N_ST):
        if i > 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            if i == N_ST - N_ST_SCAN:        # phase 11f's start state
                scan0 = clone_tree(state)
            t0 = time.perf_counter()
            state, out = fe.step_donated(state, apply_undistort(um0, f0[i]),
                                         ts[i], apply_undistort(um1, f1[i]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        kl_pair.append(state.last_kl_num_pair)
    st_launches = read_launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    pos = np.stack([o.nav.Pos.cpu().numpy() for o in outs])
    kl = [int(o.nav.kl_num) for o in outs]
    kl1 = [int(k) for k in kl_pair]
    klm = [int(o.nav.klm_num) for o in outs]
    snum = [int(o.stereo_num) for o in outs]
    est = [bool(o.nav.estimation_ok) for o in outs]
    est_share = float(np.mean(est[2:]))
    k1 = st_launches["detect_candidates_cuda"]
    finite = bool(np.all(np.isfinite(pos)))
    # the trajectory against the written path, no scale fitted by the
    # system: pos[i - 1] is frame i
    est_on, true_on = pos[move:], pos_true[move + 1:N_ST]
    extent = float(np.ptp(true_on, axis=0).max())
    ate = ate_rmse(est_on, true_on, with_scale=True)
    ate_metric = ate_rmse(est_on, true_on, with_scale=False)
    scale = align_umeyama(est_on, true_on)[0]
    # outs[j] is frame j + 1: the share's bar steps up at frame
    # ST_SHARE_SETTLED
    share = [n / m for n, m in zip(snum, klm)]
    early = share[1:ST_SHARE_SETTLED - 1]
    settled = share[ST_SHARE_SETTLED - 1:]
    st_ok = ([n >= ST_NUM_FLOOR for n in snum[1:]]
             + [s >= ST_NUM_SHARE_EARLY for s in early]
             + [s >= ST_NUM_SHARE for s in settled])
    ok11 = (finite and min(kl) >= KL_FLOOR and min(kl1) >= KL_FLOOR
            and all(st_ok) and est_share >= 0.9 and k1 == 2 * N_ST
            and st_launches["minimizer_rv"] == N_ST - 1
            and st_launches["correct_and_augment"] == N_ST - 1
            and st_launches["md_match"] == N_ST - 1
            and st_launches["md_depth"] == N_ST - 1
            and ST_SCALE_BAND[0] < scale < ST_SCALE_BAND[1]
            and ate_metric <= ST_ATE_METRIC * extent)
    steady = step_ms[5:]
    np.savez(os.path.join(OUT, "stereo_path.npz"), pos=pos, kl=kl, kl1=kl1,
             klm=klm, stereo_num=snum, est=est, step_ms=step_ms,
             pos_true=pos_true)
    emit({"phase": "stereo_main", "ok": ok11, "frames": N_ST,
          "launches": st_launches, "k1_launches": k1,
          "k1_launches_expected": 2 * N_ST,
          "k3_launches_expected": N_ST - 1, "kl_min_cam0": min(kl),
          "kl_min_cam1": min(kl1), "kl_floor": KL_FLOOR,
          "stereo_num_min": min(snum[1:]), "klm_min": min(klm),
          "stereo_num_floor": ST_NUM_FLOOR,
          "stereo_share_min_frames_2_9": min(early),
          "stereo_share_floor_frames_2_9": ST_NUM_SHARE_EARLY,
          "stereo_share_min_settled": min(settled),
          "stereo_share_floor_settled": ST_NUM_SHARE,
          "share_settled_from_frame": ST_SHARE_SETTLED,
          "est_ok_share_after_2": est_share,
          "VScaleC": float(state.VScaleC), "Kp": float(state.Kp),
          "scale_vs_path": scale, "scale_band": ST_SCALE_BAND,
          "ate_vs_path": ate, "ate_vs_path_metric": ate_metric,
          "path_extent": extent, "ate_metric_bar": ST_ATE_METRIC * extent,
          "pos_finite": finite,
          "ms_per_frame_median": statistics.median(steady),
          "ms_per_frame_min": min(steady), "warmup_frames": 5,
          "read_s": read_s,
          "timing": "host clock around both undistortions + step_donated "
                    "+ synchronize",
          "peak_device_mb": peak_mb, "card": smi})
    if not ok11:
        return {"stereo_main": st_launches}, False

    # ---- 11f. the stereo graph against the eager stereo steps -----------
    scan_launches, ok11f = stereo_scan_phase(smi, fe, scan0, um0, um1, f0,
                                             f1, ts)
    if not ok11f:
        return {"stereo_main": st_launches, "stereo_scan": scan_launches}, \
            False

    # ---- 11b. where the stereo step's time goes -------------------------
    pf0 = [apply_undistort(um0, f) for f in f0[N_ST:N_ST + N_ST_PROFILE]]
    pf1 = [(apply_undistort(um1, g),) for g in f1[N_ST:N_ST + N_ST_PROFILE]]
    _, prof = profile_steps(fe, state, pf0, ts[N_ST:N_ST + N_ST_PROFILE],
                            extra=pf1, table="profile_stereo.txt")
    busy = prof["device_busy_ms_per_step"]
    emit({"phase": "stereo_profile", **prof,
          "k1_share_of_busy": (prof["k1_ms_per_step"] / busy if busy
                               else None),
          "device_idle_share": 1.0 - busy / statistics.median(steady),
          "idle_share_of": "median unprofiled ms/frame of phase 11",
          "card": smi})

    # ---- 11c. run_vo --euroc --stereo (and --imu) on the card -----------
    from rebvo_tpu_torch.apps import run_vo
    cfg = os.path.join(OUT, "stereo_run_vo.cfg")
    save_config(p, cfg)
    rv = {}
    for label, extra in (("stereo_run_vo", []),
                         ("stereo_vio_run_vo", ["--imu"])):
        zero_launches()
        out_dir = os.path.join(OUT, label)
        run_vo.main(["--euroc", st_dir, "--stereo", "--max-frames",
                     str(N_ST), "--out-dir", out_dir, "--config", cfg] + extra)
        rv[label] = read_launches()
        tum, rpos = _tum_rows(os.path.join(out_dir, p.TrayFile))
        finite = tum.shape[0] == N_ST - 1 and bool(np.all(np.isfinite(tum)))
        ok = finite and rv[label]["detect_candidates_cuda"] == 2 * N_ST
        line = {"phase": label, "tum_rows": int(tum.shape[0]),
                "expected_rows": N_ST - 1, "launches": rv[label]}
        if not extra:
            # the same donated steps as phase 11: phase 7's bar
            tol = pos_tolerance(pos)
            dpos = float(np.abs(rpos - pos).max()) if finite else float("inf")
            ok = ok and dpos <= tol
            line.update(max_abs_pos_diff=dpos, tolerance=tol)
        else:
            # stereo-VIO: K in the filter's band on every filtered frame,
            # the trajectory near the written path, rigidly aligned
            on = 5 + p.InitBiasFrameNum
            K = read_mfile(os.path.join(out_dir, p.LogFile))["Kscale"][:, 0]
            k_band = bool(np.all((K[on - 1:] > VI_K_FLOOR) &
                                 (K[on - 1:] < VI_K_CEIL)))
            est_on, true_on = rpos[on - 1:], pos_true[on:N_ST]
            extent = float(np.ptp(true_on, axis=0).max())
            ate_metric = (ate_rmse(est_on, true_on, with_scale=False)
                          if finite else float("inf"))
            ok = (ok and k_band
                  and ate_metric <= ST_VIO_ATE_METRIC * extent)
            line.update(K_in_band=k_band, K_min=float(K[on - 1:].min()),
                        K_max=float(K[on - 1:].max()), K_final=float(K[-1]),
                        K_band=[VI_K_FLOOR, VI_K_CEIL],
                        ate_vs_path_metric=ate_metric, path_extent=extent,
                        ate_metric_bar=ST_VIO_ATE_METRIC * extent,
                        scale_vs_path=(align_umeyama(est_on, true_on)[0]
                                       if finite else None))
        emit({**line, "ok": ok})
        if not ok:
            return {"stereo_main": st_launches, **rv}, False

    # ---- 11d. the first stereo frames on the CPU ------------------------
    fe_cpu = VOFrontend(p, device="cpu")
    uc0 = build_undistort_map(fe_cpu.cam, device="cpu")
    uc1 = build_undistort_map(fe_cpu.cam_pair, device="cpu")
    c0 = [apply_undistort(uc0, f.cpu()) for f in f0[:N_ST_CPU]]
    c1 = [apply_undistort(uc1, g.cpu()) for g in f1[:N_ST_CPU]]
    st = fe_cpu.bootstrap(fe_cpu.init(), c0[0], ts[0], c1[0])
    cpu = []
    for i in range(1, N_ST_CPU):
        st, out = fe_cpu.step_donated(st, c0[i], ts[i], c1[i])
        cpu.append((out, int(st.last_kl_num_pair)))
    n = N_ST_CPU - 1
    cpu_pos = np.stack([o.nav.Pos.numpy() for o, _ in cpu])
    cpu_kl = [int(o.nav.kl_num) for o, _ in cpu]
    cpu_kl1 = [k for _, k in cpu]
    cpu_st = [int(o.stereo_num) for o, _ in cpu]
    st_gap = max(abs(a - b) / max(b, 1) for a, b in zip(cpu_st, snum[:n]))
    tol = pos_tolerance(cpu_pos)
    dpos = float(np.abs(cpu_pos - pos[:n]).max())
    ok11d = (cpu_kl == kl[:n] and cpu_kl1 == kl1[:n]
             and st_gap <= ST_CPU_NUM and dpos <= tol)
    emit({"phase": "stereo_cpu", "ok": ok11d, "frames": N_ST_CPU,
          "kl_cpu": cpu_kl, "kl_card": kl[:n], "kl_cam1_cpu": cpu_kl1,
          "kl_cam1_card": kl1[:n], "stereo_num_cpu": cpu_st,
          "stereo_num_card": snum[:n], "stereo_num_max_rel_diff": st_gap,
          "stereo_num_rtol": ST_CPU_NUM, "max_abs_pos_diff": dpos,
          "tolerance": tol})
    return {"stereo_main": st_launches, **rv}, ok11d


def vosystem_phase(smi, p, frames, ts, pos4):
    """Phase 11e: VOSystem on the card over phase 4's first N_SYS mono
    frames, frame by frame in turns with step_donated on a twin
    frontend (the order swapped every frame), and the system's per-frame
    host read (_keyframe_and_log: one transfer of the keyframe decision
    and the pose-log measurement, the 6x6 pinv, the keyframe push) timed
    on its own after a synchronize. Returns (launch counts, ok)."""
    from rebvo_tpu_torch.backend.keyframe import load_keyframes
    from rebvo_tpu_torch.backend.posegraph import (PoseGraphLog,
                                                   optimize_pose_graph,
                                                   problem_from_log)
    from rebvo_tpu_torch.system import VOSystem

    sys_ = VOSystem(p, device="cuda")
    fe = VOFrontend(p, device="cuda")
    keyframe_and_log = sys_._keyframe_and_log
    read_ms = []

    def timed_read(out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keyframe_and_log(out)
        read_ms.append((time.perf_counter() - t0) * 1e3)

    sys_._keyframe_and_log = timed_read
    sys_launches = dict.fromkeys(read_launches(), 0)
    fe_state = None

    def system_frame(i):
        zero_launches()
        t0 = time.perf_counter()
        out = sys_.process_frame(frames[i], ts[i])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in read_launches().items():
            sys_launches[k] += v
        return out, ms

    def step_frame(i):
        nonlocal fe_state
        t0 = time.perf_counter()
        if i == 0:
            fe_state = fe.bootstrap(fe.init(), frames[0], ts[0])
        else:
            fe_state, _ = fe.step_donated(fe_state, frames[i], ts[i])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    outs, sys_ms, step_ms = [], [], []
    for i in range(N_SYS):
        if i % 2:
            ms_b = step_frame(i)
            out, ms_a = system_frame(i)
        else:
            out, ms_a = system_frame(i)
            ms_b = step_frame(i)
        if i > 0:
            outs.append(out)
            sys_ms.append(ms_a)
            step_ms.append(ms_b)
    spos = np.stack([o.nav.Pos.cpu().numpy() for o in outs])
    ref = pos4[:N_SYS - 1]
    tol = pos_tolerance(ref)
    dpos = float(np.abs(spos - ref).max())
    saved = sum(bool(o.kf_saved) for o in outs)
    n_kf = int(sys_.kf_store.count)
    prob, n_nodes = problem_from_log(sys_.pose_log, device="cuda")
    R0 = torch.eye(3, device="cuda").repeat(n_nodes, 1, 1)
    _, _, costs = optimize_pose_graph(
        R0, torch.zeros((n_nodes, 3), device="cuda"), prob, iters=3)
    costs = costs.cpu().numpy()
    snap = os.path.join(OUT, "vosystem")
    os.makedirs(snap, exist_ok=True)
    kf_path = os.path.join(snap, "kf_list.npz")
    pg_path = os.path.join(snap, "poses_list.npz")
    sys_.TakeSnapshot(kf_path, pg_path)
    back_kf = load_keyframes(kf_path, device="cuda")
    back_pg = PoseGraphLog.load(pg_path)
    snap_ok = (int(back_kf.count) == n_kf
               and len(back_pg.meas) == len(sys_.pose_log.meas)
               and bool(torch.equal(back_kf.Pos, sys_.kf_store.Pos)))
    ok = (dpos <= tol and n_kf == min(saved, sys_.kf_store.capacity)
          and n_kf >= 1 and len(sys_.pose_log.meas) == N_SYS - 1
          and len(read_ms) == N_SYS - 1
          and bool(np.all(np.isfinite(costs))) and snap_ok
          and sys_launches["detect_candidates_cuda"] == N_SYS
          and sys_launches["minimizer_rv"] == N_SYS - 1
          and sys_launches["correct_and_augment"] == N_SYS - 1
          and sys_launches["md_match"] == N_SYS - 1
          and sys_launches["md_depth"] == N_SYS - 1)
    # frames 6 on (outs[j] is frame j + 1)
    diff = [a - b for a, b in zip(sys_ms[5:], step_ms[5:])]
    emit({"phase": "vosystem", "ok": ok, "frames": N_SYS,
          "launches": sys_launches, "k3_launches_expected": N_SYS - 1,
          "max_abs_pos_diff_vs_phase4": dpos,
          "tolerance": tol, "kf_saved": saved, "kf_store_count": n_kf,
          "pose_log_meas": len(sys_.pose_log.meas),
          "pose_graph_costs": costs.tolist(), "snapshot_ok": snap_ok,
          "host_read_ms_median": statistics.median(read_ms[5:]),
          "host_read_ms_max": max(read_ms[5:]),
          "ms_per_frame_median": statistics.median(sys_ms[5:]),
          "step_donated_ms_per_frame_median": statistics.median(step_ms[5:]),
          "paired_diff_ms_median": statistics.median(diff),
          "timing": "host clock, frames 6 on: process_frame and "
                    "step_donated (twin frontend) in turns each frame, "
                    "each + synchronize; the host read alone after a "
                    "synchronize", "card": smi})
    return sys_launches, ok


def ba_phase(smi):
    """Phase 12: the offline BA on the card at tests/test_ba_scale.py's
    scale, against the port's CPU solve of the same input. Returns ok."""
    from rebvo_tpu_torch.backend import ba
    from rebvo_tpu_torch.profiling import H100_F32_FLOPS
    t0 = time.perf_counter()
    R_true, p_true, _, prob = ba.synth_ring_problem(
        BA_F, BA_L, BA_OBS, BA_ZFM, device="cuda")
    rng = np.random.RandomState(1)
    p0 = p_true + rng.randn(BA_F, 3).astype(np.float32) * 0.03
    R0_d = torch.as_tensor(R_true, device="cuda")
    p0_d = torch.as_tensor(p0, device="cuda")
    setup_s = time.perf_counter() - t0

    def solve():
        return ba.ba_solve(R0_d, p0_d, prob, BA_ZFM, iters=BA_ITERS)
    solve()                                   # cuBLAS / cuSOLVER set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    R2, p2, rho2, costs = solve()
    b.record()
    torch.cuda.synchronize()
    solve_host_ms = (time.perf_counter() - t0) * 1e3
    solve_ms = a.elapsed_time(b)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    final = float(ba._eval_cost(R2, p2, prob._replace(rho=rho2), BA_ZFM,
                                3.0))
    costs = costs.cpu().numpy()

    # the reduced camera system's product alone, at this problem's S
    pb = prob
    terms = ba._build_terms(R0_d, p0_d, pb, BA_ZFM, 3.0)
    _, _, h_l, _, S, _ = ba._reduce_terms(*terms, pb, BA_F)
    inv_h = torch.where(h_l > 1e-12, 1.0 / (h_l + 1e-3),
                        torch.zeros_like(h_l))
    s_ms = time_cuda(lambda: (S * inv_h[:, None]).T @ S, n=20)
    s_flops = 2.0 * BA_L * (6 * BA_F) ** 2
    del terms, S

    # the same seeded input on the CPU: after BA_ITERS as above (reported),
    # and both at the floor (the bar)
    cpu = ba.synth_ring_problem(BA_F, BA_L, BA_OBS, BA_ZFM, device="cpu")[3]
    t0 = time.perf_counter()
    _, p_cpu, _, c_cpu = ba.ba_solve(torch.as_tensor(R_true),
                                     torch.as_tensor(p0), cpu, BA_ZFM,
                                     iters=BA_ITERS)
    cpu_s = time.perf_counter() - t0
    _, pf_cpu, _, cf_cpu = ba.ba_solve(torch.as_tensor(R_true),
                                       torch.as_tensor(p0), cpu, BA_ZFM,
                                       iters=BA_ITERS_FLOOR)
    _, pf_card, _, cf_card = ba.ba_solve(R0_d, p0_d, prob, BA_ZFM,
                                         iters=BA_ITERS_FLOOR)
    pc, pd = p_cpu.numpy(), p2.cpu().numpy()
    card_cpu = ate_rmse(pf_card.cpu().numpy(), pf_cpu.numpy())
    ate0 = ate_rmse(p0, p_true)
    ate2 = ate_rmse(pd, p_true)
    ok = bool(np.all(np.isfinite(costs)) and np.isfinite(final)
              and final <= BA_COST_DROP * costs[0]
              and costs[-1] <= BA_COST_DROP * costs[0]
              and ate2 < BA_ATE_DROP * ate0
              and card_cpu <= BA_CARD_CPU_ATE)
    emit({"phase": "ba", "ok": ok, "keyframes": BA_F, "landmarks": BA_L,
          "observations": BA_L * BA_OBS, "iters": BA_ITERS,
          "costs": costs.tolist(), "cost_final": final,
          "cost_drop_bar": BA_COST_DROP,
          "cpu_costs": c_cpu.numpy().tolist(),
          "ate_start": ate0, "ate_card": ate2, "ate_bar_share": BA_ATE_DROP,
          "ate_card_vs_cpu_after_iters": ate_rmse(pd, pc),
          "max_abs_pos_card_vs_cpu_after_iters": float(np.abs(pd - pc).max()),
          "floor_iters": BA_ITERS_FLOOR,
          "floor_costs_card": cf_card.cpu().numpy().tolist(),
          "floor_costs_cpu": cf_cpu.numpy().tolist(),
          "ate_card_vs_cpu_at_floor": card_cpu,
          "card_cpu_bar": BA_CARD_CPU_ATE,
          "solve_ms": solve_ms, "solve_host_ms": solve_host_ms,
          "ms_per_iter": solve_ms / BA_ITERS, "peak_device_mb": peak_mb,
          "s_shape": [BA_L, 6 * BA_F], "s_product_ms": s_ms,
          "s_product_share_of_iter": s_ms / (solve_ms / BA_ITERS),
          "s_product_bound_ms": s_flops / H100_F32_FLOPS * 1e3,
          "s_product_bound_by": "operations", "cpu_solve_s": cpu_s,
          "setup_s": setup_s,
          "timing": "CUDA events around ba_solve (one call after a "
                    "warm-up) and around the S product (median of 20)",
          "card": smi})
    return ok


def parity_phase(smi):
    """Phase 12b: the `loop` parity row on the card. Returns (K1
    launches, ok)."""
    from rebvo_tpu_torch.apps import parity
    # the dataset and the keyframe stores (~70 MB) stay on the machine
    seq_dir = os.path.join("build", "smoke_parity", "loop")
    shutil.rmtree(seq_dir, ignore_errors=True)
    os.makedirs(seq_dir)
    res = parity.evaluate_sequence(
        seq_dir, "loop", PARITY_FRAMES, parity.seq_seed("loop"),
        skip_ref=True, ba_every=PARITY_KF_EVERY)
    with open(os.path.join(OUT, "parity_row.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    k1 = res["repo_kernel_launches"].get("detect_candidates_cuda", 0)
    ate = res["ate_repo_vs_gt"]
    ba_res = res.get("ba", {})
    ok = (np.isfinite(ate) and ate <= PARITY_ATE_BAR * PARITY_JAX_ATE
          and "ba_error" not in res and bool(ba_res)
          and ba_res["cost_final"] <= ba_res["cost_initial"]
          and k1 == PARITY_FRAMES)
    emit({"phase": "parity_row", "ok": ok, "sequence": "loop",
          "frames": PARITY_FRAMES, "kf_every": PARITY_KF_EVERY,
          "ate_repo_vs_gt": ate, "ate_jax_parity_r05": PARITY_JAX_ATE,
          "ate_bar": PARITY_ATE_BAR * PARITY_JAX_ATE, "ba": ba_res,
          "ba_error": res.get("ba_error"), "k1_launches": k1,
          "k1_launches_expected": PARITY_FRAMES,
          "launches": res["repo_kernel_launches"],
          "render_s": res.get("render_s"),
          "repo_wall_s": res["repo_wall_s"], "card": smi})
    return k1, ok


def batched_phase(smi, p, kw):
    """Phase 13: the batched multi-sequence step on the card. Returns
    (launches of each kernel, K1's [16,480,752] numbers, ok)."""
    import warnings

    from rebvo_tpu_torch.bench import rendered_lanes
    from rebvo_tpu_torch.parallel.mesh import shard_sequences, stack_lanes
    dev = torch.device("cuda")
    n = N_BATCH_STEPS + 1
    t0 = time.perf_counter()
    lanes = torch.as_tensor(rendered_lanes(p, n, N_LANES), device=dev)
    render_s = time.perf_counter() - t0
    ts = [torch.full((N_LANES,), i / p.config_fps, device=dev)
          for i in range(n)]
    fe = VOFrontend(p, device="cuda")
    bootv = shard_sequences(fe.bootstrap, [dev])
    stepv = shard_sequences(fe.step_donated, [dev])
    init = stack_lanes(fe.init(), N_LANES)
    # the captures (they sync), from a throw-away state; vmap warns once
    # for each op it runs by its per-lane fallback
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st = bootv([init], [lanes[:, 0]], [ts[0]])
        stepv(st, [lanes[:, 1]], [ts[1]])
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    capture_s = time.perf_counter() - t0
    fallback = sorted({m.group(1) for w in caught
                       for m in [re.search(r"batching rule for (\S+?)\.",
                                           str(w.message))] if m})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    states = bootv([init], [lanes[:, 0]], [ts[0]])
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(1, n):
            states, out = stepv(states, [lanes[:, i]], [ts[i]])
            outs.append(out[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    got = read_launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    bpos = torch.stack([o.nav.Pos for o in outs], 1).cpu().numpy()
    bkl = torch.stack([o.nav.kl_num for o in outs], 1).cpu().numpy()

    # each lane alone, step_donated on its own frontend
    fe1 = VOFrontend(p, device="cuda")
    lanes_res, ok_lanes = [], True
    for b in range(N_LANES):
        st = fe1.bootstrap(fe1.init(), lanes[b, 0], ts[0][b])
        pos, kl = [], []
        for i in range(1, n):
            st, o = fe1.step_donated(st, lanes[b, i], ts[i][b])
            pos.append(o.nav.Pos.cpu().numpy())
            kl.append(int(o.nav.kl_num))
        if b == 0:
            st0 = st
        pos = np.stack(pos)
        tol = pos_tolerance(pos)
        dpos = float(np.abs(bpos[b] - pos).max())
        ok_b = kl == bkl[b].tolist() and dpos <= tol
        ok_lanes = ok_lanes and ok_b
        lanes_res.append({"lane": b, "ok": ok_b,
                          "kl_equal": kl == bkl[b].tolist(),
                          "max_abs_pos_diff": dpos, "tolerance": tol})

    # one batched replay against one single step of the same input, lane
    # 0's state after the same steps and its frame, under the profiler
    _, acts_b = _device_timeline(_profiled(
        lambda: stepv(states, [lanes[:, 1]], [ts[1]])))
    _, acts_1 = _device_timeline(_profiled(
        lambda: fe1.step_donated(st0, lanes[0, 1], ts[1][0])))
    busy_b = sum(a[1] - a[0] for a in acts_b) / 1e3
    busy_1 = sum(a[1] - a[0] for a in acts_1) / 1e3

    # K1 at [16, 480, 752] against its plain version
    x = lanes[:, 1].contiguous()
    th = torch.full((N_LANES,), p.DetectorThresh, device=dev)
    ck = cs.detect_candidates_cuda(x, th, **kw)
    cp = cs.detect_candidates_plain(x, th, **kw)
    torch.cuda.synchronize()
    mism, err, err_all = compare(ck, cp)
    l2 = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    k_ms = device_ms(lambda: cs.detect_candidates_cuda(x, th, **kw), 50,
                     l2.zero_)
    plain_ms = device_ms(lambda: cs.detect_candidates_plain(x, th, **kw),
                         10, l2.zero_)
    del l2
    sizes0, sizes1, _, _ = scale_space_plan(p.Sigma0, p.KSigma, 3)
    t_bytes = x.numel() * (4 + 1 + 5 * 4) / H100_MEM_BYTES_PER_S * 1e3
    t_ops = x.numel() * k1_ops_per_pixel(
        sizes0, sizes1, p.DetectorPlaneFitSize) / H100_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    k1 = {"shape": list(x.shape), "mask_mismatch": mism, "max_abs_err": err,
          "max_abs_err_all_pixels": err_all, "kernel_ms": k_ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
          "x_bound": k_ms / bound_ms}
    k1_launches = got["detect_candidates_cuda"]
    ok = (ok_lanes and k1_launches == n and mism == 0 and err < 5e-3
          and got["minimizer_rv"] == N_BATCH_STEPS
          and got["correct_and_augment"] == N_BATCH_STEPS
          and got["md_match"] == got["md_depth"] == N_BATCH_STEPS
          and bool(np.all(np.isfinite(bpos))))
    frames = N_LANES * N_BATCH_STEPS
    emit({"phase": "batched", "ok": ok, "lanes": N_LANES,
          "steps": N_BATCH_STEPS, "launches": got,
          "k1_launches_expected": n, "k3_launches_expected": N_BATCH_STEPS,
          "lane_checks": lanes_res,
          "ms_per_batched_step": wall_ms / N_BATCH_STEPS,
          "ms_per_frame": wall_ms / frames,
          "frames_per_s": frames / (wall_ms / 1e3),
          "peak_device_mb": peak_mb,
          "replay_device_activities": len(acts_b),
          "replay_device_busy_ms": busy_b,
          "single_step_device_activities": len(acts_1),
          "single_step_device_busy_ms": busy_1,
          "activity_ratio": len(acts_b) / max(len(acts_1), 1),
          "busy_ratio": busy_b / max(busy_1, 1e-9),
          "vmap_fallback_ops": fallback, "capture_s": capture_s,
          "render_s": render_s, "k1_b16": k1,
          "timing": "host clock around the 10 batched calls (input copy, "
                    "replay, output clones) + synchronize; activities "
                    "and busy ms by torch.profiler over one call each",
          "card": smi})
    return got, k1, ok


def run_batch_phase(smi):
    """Phase 13b: the run_batch CLI on the card. Returns ok."""
    out_dir = os.path.join(OUT, "run_batch")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "rebvo_tpu_torch.apps.run_batch", "--synthetic",
                        "20", "--batch", str(N_LANES), "--out-dir", out_dir],
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    line, rows = {}, []
    if r.returncode == 0:
        line = json.loads(r.stdout.strip().splitlines()[-1])
        for b in range(N_LANES):
            tum = np.loadtxt(os.path.join(out_dir, f"tray_seq{b}.txt"))
            rows.append(int(tum.shape[0]) if np.all(np.isfinite(tum))
                        else -1)
    ok = (r.returncode == 0 and line.get("sequences") == N_LANES
          and rows == [19] * N_LANES)
    emit({"phase": "run_batch", "ok": ok, "rc": r.returncode, "line": line,
          "tum_rows": rows, "wall_s": wall,
          "stderr": r.stderr[-800:] if r.returncode else "", "card": smi})
    return ok


def distributed_phase(smi, kf):
    """Phase 14: the sharded BA in one process, run_ba --shards on the
    keyframe store `kf`, and run_multihost over gloo on the card. Returns
    ok."""
    from rebvo_tpu_torch.apps import run_ba
    from rebvo_tpu_torch.backend import ba
    R_true, p_true, _, prob = ba.synth_ring_problem(
        BA_F, BA_L, BA_OBS, BA_ZFM, device="cuda")
    rng = np.random.RandomState(1)
    p0 = torch.as_tensor(p_true + rng.randn(BA_F, 3).astype(np.float32) *
                         0.03, device="cuda")
    R0 = torch.as_tensor(R_true, device="cuda")
    _, _, _, c1 = ba.ba_solve(R0, p0, prob, BA_ZFM, iters=BA_ITERS_FLOOR)
    part = ba.partition_problem(prob, BA_SHARDS)
    ba.ba_solve_sharded(R0, p0, part, BA_ZFM, n_shards=BA_SHARDS, iters=1)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    _, _, _, cs_ = ba.ba_solve_sharded(R0, p0, part, BA_ZFM,
                                       n_shards=BA_SHARDS,
                                       iters=BA_ITERS_FLOOR)
    b.record()
    torch.cuda.synchronize()
    c1, cs_ = c1.cpu().double().numpy(), cs_.cpu().double().numpy()
    in_proc = {"shards": BA_SHARDS, "costs_one": c1.tolist(),
               "costs_sharded": cs_.tolist(),
               "sharded_solve_ms": a.elapsed_time(b),
               "first_cost_rel_diff": float(abs(cs_[0] - c1[0]) / c1[0]),
               "floor_diff_rel_first": float(abs(cs_[-1] - c1[-1]) /
                                             c1[0])}
    ok_in = (in_proc["first_cost_rel_diff"] <= 1e-5
             and in_proc["floor_diff_rel_first"] <= BA_SHARD_RTOL)

    # run_ba --shards 4 against --shards 1
    cli = {}
    for n in (1, BA_SHARDS):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_ba.main([kf, "--out", os.path.join(
                "build", f"kf_shards{n}.npz"), "--rounds", "1", "--iters",
                str(BA_STORE_ITERS), "--field-radius", "2", "--huber-k",
                "1.0", "--shards", str(n)])
        cli[n] = dict(json.loads(buf.getvalue().strip().splitlines()[-1]),
                      rc=rc)
    # both at the floor: 12 iterations leave a store's solve short of it
    # (a 7-keyframe store read 565.0 and 539.5 from 10678.0 on an H100),
    # so BA_STORE_ITERS
    c0 = cli[1]["cost_initial"]
    final_gap = abs(cli[BA_SHARDS]["cost_final"] - cli[1]["cost_final"]) / c0
    ok_cli = (cli[1]["rc"] == 0 and cli[BA_SHARDS]["rc"] == 0
              and cli[BA_SHARDS]["shards"] == BA_SHARDS
              and abs(cli[BA_SHARDS]["cost_initial"] - c0) <= 1e-5 * c0
              and final_gap <= BA_SHARD_RTOL)

    # two ranks over gloo, sharing the card
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "rebvo_tpu_torch.apps.run_multihost", "--nprocs",
                        "2", "--check-ba", "--backend", "gloo",
                        "--timeout", "400"],
                       capture_output=True, text=True, timeout=600)
    mh_wall = time.perf_counter() - t0
    mh = json.loads(r.stdout.strip().splitlines()[-1]) \
        if r.returncode == 0 else {}
    pt = (mh.get("scaling") or [{}])[-1]
    ok_mh = (r.returncode == 0 and pt.get("psum_ok") is True
             and pt.get("pos_finite") is True
             and pt.get("ba_parity_err") is not None
             and pt["ba_parity_err"] < MULTIHOST_PARITY)
    ok = ok_in and ok_cli and ok_mh
    emit({"phase": "distributed", "ok": ok, "in_process": in_proc,
          "in_process_ok": ok_in, "run_ba": cli, "run_ba_ok": ok_cli,
          "run_ba_floor_gap_rel_first": final_gap,
          "run_ba_bar_rel_first": BA_SHARD_RTOL, "multihost": mh,
          "multihost_ok": ok_mh, "multihost_parity_bar": MULTIHOST_PARITY,
          "multihost_wall_s": mh_wall,
          "multihost_stderr": r.stderr[-800:] if r.returncode else "",
          "timing": "CUDA events around one sharded solve; run_multihost's "
                    "numbers are gloo through the host, not a rate",
          "card": smi})
    return ok


def free_udp_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _receive(rx, pkts, n, stop):
    """Collect up to n packets from `rx` into `pkts` (a thread's body);
    once `stop` is set, return at the first silent half second."""
    while len(pkts) < n:
        pkt = rx.recv(timeout_ms=500)
        if pkt is not None:
            pkts.append(pkt)
        elif stop.is_set():
            return


def m13_phase(smi, p, gpu_frames, ts):
    """Phase 15: the last modules on the card at the default config.
    (a) VOSystem with VideoNetEnabled=1 (raw video) over N_TEL + 1 of
    phase 4's frames, an EdgeMapReceiver in a thread of this process, in
    turns with a twin VOSystem without the sender; (b) fill_depth on the
    card against the CPU on each sent edge map in every bound_mode;
    (c) build_ocgrid and ray_cut_visibility over the fills' world points,
    card against the CPU on the same points; (d) apps.visualizer.run over
    loopback with its dense fills on the card; (e) run_vo --save-video
    raw; (f) run_vo --interactive with 's' on stdin; (g) save_state after
    10 frames, load_state into a fresh state, 5 more steps against the
    run that was not interrupted. Returns (K1 launches of (a), ok)."""
    import threading

    from rebvo_tpu_torch.apps import run_vo, visualizer
    from rebvo_tpu_torch.backend import surface
    from rebvo_tpu_torch.io import native, telemetry
    from rebvo_tpu_torch.io.telemetry import EdgeMapReceiver, EdgeMapSender
    from rebvo_tpu_torch.io.video import _to_u8, read_video_stream
    from rebvo_tpu_torch.kernels import depth_filler
    from rebvo_tpu_torch.runtime_utils import load_state, save_state
    from rebvo_tpu_torch.system import VOSystem

    out_dir = os.path.join(OUT, "m13")
    os.makedirs(out_dir, exist_ok=True)
    res, oks = {"phase": "m13_m15", "card": smi}, {}

    # (a) telemetry --------------------------------------------------------
    port = free_udp_port()
    rx = EdgeMapReceiver("127.0.0.1", port)
    pkts, stop = [], threading.Event()
    th = threading.Thread(target=_receive, args=(rx, pkts, N_TEL, stop))
    th.start()
    tel = VOSystem(p.replace(VideoNetEnabled=1, VideoNetHost="127.0.0.1",
                             VideoNetPort=port, EncoderType=0),
                   device="cuda")
    twin = VOSystem(p, device="cuda")
    send, send_ms = tel._send, []

    def timed_send(out, frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        send(out, frame)
        send_ms.append((time.perf_counter() - t0) * 1e3)

    tel._send = timed_send
    k1 = 0
    tel_ms, twin_ms, want, klms = [], [], [], []
    pos, poses, scales = [], [], []

    def tel_frame(i):
        nonlocal k1
        zero_launches()
        t0 = time.perf_counter()
        out = tel.process_frame(gpu_frames[i], ts[i])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        k1 += read_launches()["detect_candidates_cuda"]
        return out, ms

    def twin_frame(i):
        t0 = time.perf_counter()
        twin.process_frame(gpu_frames[i], ts[i])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for i in range(N_TEL + 1):
        if i % 2:
            ms_b = twin_frame(i)
            out, ms_a = tel_frame(i)
        else:
            out, ms_a = tel_frame(i)
            ms_b = twin_frame(i)
        if out is None:
            continue
        tel_ms.append(ms_a)
        twin_ms.append(ms_b)
        # the reference, outside the timed frame: this frame's edge map
        # quantized on the host
        scale = float(out.nav.scale)
        want.append(native.dequantize_keylines(
            native.quantize_keylines(tel.state.klm, scale)[0], scale))
        klms.append(clone_tree(tel.state.klm))
        pos.append(out.nav.Pos.cpu().numpy())
        poses.append(out.nav.Pose.clone())
        scales.append(scale)
    stop.set()
    th.join()
    tel.sender.close()
    rx.close()
    equal = 0
    for q in pkts:
        k = q["frame_id"]
        equal += int(k < len(want) and all(
            np.array_equal(q["keylines"][f], v) for f, v in want[k].items())
            and np.array_equal(q["Pos"], pos[k]))
    oks["telemetry"] = (len(pkts) >= TEL_MIN_PACKETS and equal == len(pkts)
                        and tel.telemetry_dropped == 0
                        and k1 == N_TEL + 1)
    diff = [a - b for a, b in zip(tel_ms[5:], twin_ms[5:])]
    res["telemetry"] = {
        "ok": oks["telemetry"], "frames": N_TEL + 1, "packets_sent": N_TEL,
        "packets_received": len(pkts), "packets_min": TEL_MIN_PACKETS,
        "packets_equal_host_quantized": equal,
        "dropped_sends": tel.telemetry_dropped,
        "receiver_rcvbuf_bytes": rx.port.rcvbuf,
        "keylines_per_packet": [int(q["n"]) for q in pkts],
        "packet_bytes_median": statistics.median(
            [telemetry._HDR.size + int(q["n"]) * native.net_keyline_size()
             + telemetry._VHDR.size + len(q["video"]) for q in pkts])
        if pkts else None,
        "k1_launches": k1, "k1_expected": N_TEL + 1,
        "ms_per_frame_with_sender_median": statistics.median(tel_ms[5:]),
        "ms_per_frame_without_sender_median": statistics.median(twin_ms[5:]),
        "paired_diff_ms_median": statistics.median(diff),
        "send_ms_median": statistics.median(send_ms[5:]),
        "send_ms_max": max(send_ms[5:]),
        "timing": "host clock, frames 6 on: process_frame with and "
                  "without the sender (a twin VOSystem) in turns each "
                  "frame, each + synchronize; send_ms: the sender's call "
                  "alone (host copy, quantize, pack, UDP) after a "
                  "synchronize"}

    # (b) the depth filler, card against the CPU ---------------------------
    H, W = p.ImageHeight, p.ImageWidth
    fkw = dict(width=W, height=H, block=FILL_BLOCK, iters=FILL_ITERS)
    worst = {"rho": 0.0, "s_rho": 0.0}
    fixed_equal, fills = True, []
    for klm in klms:
        klm_cpu = map_tree(lambda t: t.cpu(), klm)
        for mode in ("none", "corners", "full"):
            fc = depth_filler.fill_depth(klm, bound_mode=mode, **fkw)
            fh = depth_filler.fill_depth(klm_cpu, bound_mode=mode, **fkw)
            fixed_equal &= bool(torch.equal(fc.fixed.cpu(), fh.fixed))
            for f in worst:
                a, b = getattr(fh, f), getattr(fc, f).cpu()
                worst[f] = max(worst[f], float((a - b).abs().max() /
                                               a.abs().max()))
            if mode == "none":
                fills.append(fc)
    grid = tuple(fills[0].rho.shape)
    fill_ms = time_cuda(lambda: depth_filler.fill_depth(klms[-1], **fkw),
                        n=20)
    _, acts = _device_timeline(_profiled(
        lambda: depth_filler.fill_depth(klms[-1], **fkw)))
    oks["depth_filler"] = (fixed_equal and grid == (60, 94)
                           and max(worst.values()) <= FILL_REL)
    res["depth_filler"] = {
        "ok": oks["depth_filler"], "grid": list(grid), "block": FILL_BLOCK,
        "iters": FILL_ITERS, "edge_maps": len(klms),
        "bound_modes": ["none", "corners", "full"],
        "fixed_equal": fixed_equal, "max_rel_err": worst,
        "bar_rel": FILL_REL, "ms_per_call": fill_ms,
        "launches_per_call": len(acts),
        "timing": "CUDA events, median of 20 calls (default bound mode); "
                  "launches: device activities of one profiled call"}

    # (c) the surface grid, card against the CPU on the same points -------
    # each fill's seeded cells nearer than 1 / SURFEL_RHO_MIN, unprojected,
    # scaled by the frame's K and moved to the world by its nav pose (as
    # io/edgemap_compress.EdgeMapAccumulator places segments); the rays go
    # from the last frame's camera to the first frame's surfels
    zfm = 0.5 * (p.ZfX + p.ZfY)
    Pc = torch.stack([
        (depth_filler.grid_points_3d(fc, zfm, p.PPx, p.PPy) * k) @ R.T +
        torch.as_tensor(t, device="cuda")
        for fc, R, t, k in zip(fills, poses, pos, scales)])
    Vc = torch.stack([fc.fixed & (fc.rho > SURFEL_RHO_MIN) for fc in fills])
    eye = torch.as_tensor(pos[-1], device="cuda")
    target = Pc[0][Vc[0]]
    lo, hi = surface.world_bounds(torch.cat([target, eye[None]]))
    voxel = float((hi - lo).max()) / OC_CELLS
    dims = dict(nx=OC_CELLS, ny=OC_CELLS, nz=OC_CELLS)
    gc = surface.build_ocgrid(Pc, Vc, lo, voxel, **dims)
    gh = surface.build_ocgrid(Pc.cpu(), Vc.cpu(), lo.cpu(), voxel, **dims)
    counts_equal = bool(torch.equal(gc.count.cpu(), gh.count))
    vc = surface.ray_cut_visibility(gc, eye, target)
    vh = surface.ray_cut_visibility(gh, eye.cpu(), target.cpu())
    mism = float((vc.cpu() != vh).float().mean())
    oc_ms = time_cuda(lambda: surface.build_ocgrid(Pc, Vc, lo, voxel,
                                                   **dims), n=20)
    rc_ms = time_cuda(lambda: surface.ray_cut_visibility(gc, eye, target),
                      n=20)
    oks["surface"] = (counts_equal and mism <= VIS_MISMATCH
                      and int(gc.count.sum()) > 0)
    res["surface"] = {
        "ok": oks["surface"], "points": int(Vc.numel()),
        "valid_points": int(Vc.sum()), "cells": OC_CELLS ** 3,
        "voxel": voxel, "counts_equal": counts_equal,
        "count_sum": int(gc.count.sum()), "rays": int(target.shape[0]),
        "visible_share": float(vc.float().mean()),
        "visibility_mismatch_share": mism, "mismatch_bar": VIS_MISMATCH,
        "build_ms": oc_ms, "raycut_ms": rc_ms,
        "timing": "CUDA events, median of 20 calls"}

    # (d) the visualizer over loopback -----------------------------------
    vport = free_udp_port()
    vdir = os.path.join(out_dir, "view")
    shutil.rmtree(vdir, ignore_errors=True)
    got = {}

    def rx_loop():
        got["n"] = visualizer.run("127.0.0.1", vport, vdir, max_packets=5,
                                  timeout_ms=10000, zf=p.ZfX, cx=p.PPx,
                                  dense_every=1, quiet=True, map_every=2,
                                  device="cuda")

    vth = threading.Thread(target=rx_loop)
    vth.start()
    tx = EdgeMapSender("127.0.0.1", vport, W, H, video_etype=0)
    t0 = time.perf_counter()
    sent = 0
    while vth.is_alive() and time.perf_counter() - t0 < 60:
        k = sent % len(klms)
        tx.send(klms[k], 1.0, pos[k], np.eye(3, dtype=np.float32),
                ts[k + 1], frame=gpu_frames[k + 1])
        sent += 1
        time.sleep(0.05)
    vth.join(timeout=30)
    tx.close()
    files = sorted(os.listdir(vdir)) if os.path.isdir(vdir) else []
    kinds = {k: sum(f.startswith(k + "_") for f in files)
             for k in ("edges", "topdown", "depth", "map")}
    oks["visualizer"] = (got.get("n") == 5 and kinds["edges"] == 5
                         and kinds["topdown"] == 5 and kinds["depth"] == 5
                         and kinds["map"] >= 1
                         and "received_tray.txt" in files)
    res["visualizer"] = {"ok": oks["visualizer"], "rendered": got.get("n"),
                         "sent": sent, "pngs": kinds,
                         "seconds": time.perf_counter() - t0}

    # (e) run_vo --save-video raw ------------------------------------------
    vid_dir = os.path.join(out_dir, "save_video")
    zero_launches()
    run_vo.main(["--render", str(N_VIDEO), "--max-frames", str(N_VIDEO),
                 "--out-dir", vid_dir, "--save-video", "raw"])
    vk1 = read_launches()["detect_candidates_cuda"]
    vpk = list(read_video_stream(os.path.join(vid_dir, "video.rvv")))
    vin = render_lateral(p, N_VIDEO)
    pix_equal = len(vpk) == N_VIDEO and all(
        data == _to_u8(f).tobytes() for (_, _, data), f in zip(vpk, vin))
    oks["video"] = pix_equal and vk1 == N_VIDEO
    res["video"] = {"ok": oks["video"], "packets": len(vpk),
                    "pixels_equal": pix_equal, "k1_launches": vk1}

    # (f) run_vo --interactive, 's' after frame 50 ---------------------------
    idir = os.path.join(out_dir, "interactive")
    shutil.rmtree(idir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rebvo_tpu_torch.apps.run_vo",
         "--synthetic", "2000", "--interactive", "--out-dir", idir],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=dict(
            os.environ,
            PYTHONPATH=os.path.dirname(os.path.abspath(__file__))))
    timer = threading.Timer(300, proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("frame 50"):
                proc.stdin.write("s\n")
                proc.stdin.flush()
                break
        rest, _ = proc.communicate()
        lines += rest.splitlines()
    finally:
        timer.cancel()
    n_int = [int(ln.split()[1]) for ln in lines
             if ln.startswith("processed ")]
    oks["interactive"] = (proc.returncode == 0 and bool(n_int)
                          and 50 <= n_int[0] < 2000 and all(
                              os.path.exists(os.path.join(idir, f))
                              for f in ("kf_list.npz", "poses_list.npz")))
    res["interactive"] = {"ok": oks["interactive"], "rc": proc.returncode,
                          "frames": n_int[0] if n_int else None,
                          "last_lines": lines[-3:],
                          "seconds": time.perf_counter() - t0}

    # (g) checkpoint and resume ------------------------------------------
    fe = VOFrontend(p, device="cuda")
    st = fe.bootstrap(fe.init(), gpu_frames[0], ts[0])
    for i in range(1, N_CKPT):
        st, _ = fe.step(st, gpu_frames[i], ts[i])
    ckpt = os.path.join(out_dir, "ckpt.npz")
    save_state(ckpt, st)
    back = load_state(ckpt, fe.init())
    restored_equal = all(bool(torch.equal(a, b)) for a, b in
                         zip(tree_leaves(st), tree_leaves(back)))
    runs = {}
    for label, s in (("uninterrupted", st), ("resumed", back)):
        outs = []
        for i in range(N_CKPT, N_CKPT + N_RESUME):
            s, o = fe.step(s, gpu_frames[i], ts[i])
            outs.append(o)
        runs[label] = (s, outs)
    (sa, oa), (sb, ob) = runs["uninterrupted"], runs["resumed"]
    pa = np.stack([o.nav.Pos.cpu().numpy() for o in oa])
    pb = np.stack([o.nav.Pos.cpu().numpy() for o in ob])
    kla = [int(o.nav.kl_num) for o in oa]
    klb = [int(o.nav.kl_num) for o in ob]
    tol = pos_tolerance(pa)
    dpos = float(np.abs(pa - pb).max())
    bit_equal = all(bool(torch.equal(a, b)) for a, b in
                    zip(tree_leaves(sa), tree_leaves(sb)))
    oks["checkpoint"] = restored_equal and kla == klb and dpos <= tol
    res["checkpoint"] = {
        "ok": oks["checkpoint"], "saved_after_frames": N_CKPT,
        "resumed_steps": N_RESUME, "restored_leaves_equal": restored_equal,
        "kl_equal": kla == klb, "max_abs_pos_diff": dpos, "tolerance": tol,
        "bit_equal": bit_equal, "ckpt_bytes": os.path.getsize(ckpt)}

    ok = all(oks.values())
    emit({**res, "ok": ok, "oks": oks})
    return k1, ok


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    open(os.path.join(OUT, "lines.jsonl"), "w").close()
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
    frames = render_lateral(p, N_FRAMES + N_SCAN)      # [N, 480, 752]
    rng = np.random.default_rng(0)
    uniform = rng.uniform(0, 765, (H, W)).astype(np.float32)
    batch = rng.uniform(0, 765, (4, H, W)).astype(np.float32)
    inputs = (("rendered", frames[5]), ("uniform", uniform),
              ("batch4", batch))
    ragged = tuple((f"{h}x{w}", rng.uniform(0, 765, (h, w)).astype(
        np.float32)) for h, w in RAGGED)
    # (label, frame, sigma0): the default plan on every input and shape,
    # the other plans on the rendered frame and the odd-width shape
    k1_inputs = [(lb, im, p.Sigma0) for lb, im in inputs + ragged] + [
        (f"{lb}@sigma0={s0}", im, s0) for s0 in K1_PLANS
        for lb, im in (inputs[0], ragged[1])]
    cases = []
    worst_err, worst_mism, worst_all = 0.0, 0, 0.0
    for label, img, s0 in k1_inputs:
        x = torch.as_tensor(img, device=dev)
        kws = dict(kw, sigma0=s0)
        sz0, sz1, _, _ = scale_space_plan(s0, p.KSigma, 3)
        plan = cs.launch_plan("detect_candidates", 1, *img.shape[-2:], sz0,
                              sz1, p.DetectorPlaneFitSize)
        for th in (0.03, p.DetectorThresh):
            tht = torch.full((), th, dtype=torch.float32, device=dev)
            ck = cs.detect_candidates_cuda(x, tht, **kws)
            cp = cs.detect_candidates_plain(x, tht, **kws)
            torch.cuda.synchronize()
            mism, err, err_all = compare(ck, cp)
            n_edge = int(cp.mask.sum().item())
            cases.append({"frame": label, "shape": list(img.shape),
                          "sigma0": s0, "halo": plan.halo,
                          "instantiation": "fixed" if plan.fixed
                          else "runtime", "thresh": th, "edges": n_edge,
                          "mask_mismatch": mism, "max_abs_err": err,
                          "max_abs_err_all_pixels": err_all})
            worst_err = max(worst_err, err)
            worst_mism = max(worst_mism, mism)
            worst_all = max(worst_all, err_all)
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
    # the kernel's time depends on the frame: flat regions give the
    # detector's divisions zero dividends (csrc/detect_candidates.cu)
    xu = torch.as_tensor(uniform, device=dev)
    kernel_uniform_ms = device_ms(
        lambda: cs.detect_candidates_cuda(xu, tht, **kw), 200, flush)
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
    k1_res = kernel_resources("detect_candidates",
                              info["detect_candidates"]["ptxas"])
    emit({"phase": "k1_check", "ok": ok3, "cases": cases,
          "mask_mismatch": worst_mism, "max_abs_err": worst_err,
          "max_abs_err_all_pixels": worst_all,
          "kernel_ms": kernel_ms, "x_bound": kernel_ms / bound_ms,
          "kernel_ms_uniform_frame": kernel_uniform_ms,
          "resources": k1_res, "kernel_ms_runs": [k_a, k_b],
          "plain_ms": plain_ms, "plain_ms_runs": [plain_a, plain_b],
          "call_ms": call_ms, "plain_call_ms": plain_call_ms,
          "bytes": bytes_moved, "ops": ops, "bound_ms": bound_ms,
          "bound_by": bound_by, "library_ms": None,
          "timing": "ms: median device time per call (CUPTI via "
                    "torch.profiler), L2 flushed; call_ms: CUDA events"})
    if not ok3:
        return 1

    # ---- 3b. K2 against its plain version ---------------------------------
    # Bar: 5e-3 on every map (tests/test_pallas.py's Pallas-vs-XLA bar);
    # kernel and plain version round alike, so 0.0 is expected.
    ss_cases, worst2 = [], 0.0
    k2_inputs = [(lb, im, p.Sigma0) for lb, im in inputs + ragged] + [
        (f"{lb}@sigma0={s0}", im, s0) for s0 in K2_PLANS
        for lb, im in (inputs[0], ragged[1])]
    for label, img, s0 in k2_inputs:
        xi = torch.as_tensor(img, device=dev)
        sz0, sz1, _, _ = scale_space_plan(s0, p.KSigma, 3)
        plan = cs.launch_plan("build_scale_space", 1, *img.shape[-2:], sz0,
                              sz1)
        a = cs.build_scale_space_cuda(xi, s0, p.KSigma)
        b = cs.build_scale_space_plain(xi, s0, p.KSigma)
        torch.cuda.synchronize()
        errs = {m: float((getattr(a, m) - getattr(b, m)).abs().max())
                for m in SS_MAPS}
        ss_cases.append({"frame": label, "shape": list(img.shape),
                         "sigma0": s0, "halo": plan.halo,
                         "instantiation": "fixed" if plan.fixed
                         else "runtime", "max_abs_err": errs})
        worst2 = max(worst2, *errs.values())
    ok3b = worst2 < 5e-3

    def run_k2():
        cs.build_scale_space_cuda(x, p.Sigma0, p.KSigma)

    def run_p2():
        cs.build_scale_space_plain(x, p.Sigma0, p.KSigma)

    def run_t2():
        build_scale_space(x, p.Sigma0, p.KSigma)

    plain2_a = device_ms(run_p2, 50, flush)
    k2_a = device_ms(run_k2, 200, flush)
    k2_b = device_ms(run_k2, 200, flush)
    plain2_b = device_ms(run_p2, 50, flush)
    twin_ms = device_ms(run_t2, 50, flush)
    kernel2_ms = statistics.median([k2_a, k2_b])
    plain2_ms = statistics.median([plain2_a, plain2_b])
    call2_ms = time_cuda(run_k2, 200, flush)
    plain2_call_ms = time_cuda(run_p2, 100, flush)
    # the prefix-sum twin's row sums reach ~3e6 at 480x752 (f32 ulp 0.25),
    # so it differs from K2 by far more than K2's bar: a measured number
    k2_out = cs.build_scale_space_cuda(x, p.Sigma0, p.KSigma)
    twin = build_scale_space(x, p.Sigma0, p.KSigma)
    twin_err = {m: float((getattr(k2_out, m) - getattr(twin, m)).abs().max())
                for m in SS_MAPS}
    bytes2 = px * (4 + 5 * 4)                 # frame in; 5 maps out
    ops2 = px * k2_ops_per_pixel(sizes0, sizes1)
    t2_bytes, t2_ops = bytes2 / bw * 1e3, ops2 / flops * 1e3
    bound2_ms = max(t2_bytes, t2_ops)
    bound2_by = "bytes" if t2_bytes >= t2_ops else "operations"
    k2_res = kernel_resources("build_scale_space",
                              info["build_scale_space"]["ptxas"])
    emit({"phase": "k2_check", "ok": ok3b, "cases": ss_cases,
          "max_abs_err": worst2,
          "kernel_ms": kernel2_ms, "x_bound": kernel2_ms / bound2_ms,
          "resources": k2_res, "kernel_ms_runs": [k2_a, k2_b],
          "plain_ms": plain2_ms, "plain_ms_runs": [plain2_a, plain2_b],
          "call_ms": call2_ms, "plain_call_ms": plain2_call_ms,
          "torch_twin_ms": twin_ms, "torch_twin_max_abs_diff": twin_err,
          "bytes": bytes2, "ops": ops2, "bound_ms": bound2_ms,
          "bound_by": bound2_by, "library_ms": None,
          "timing": "as k1_check"})
    if not ok3b:
        return 1
    del l2

    # ---- 3c. K3 against its plain version ---------------------------------
    k3, ok3c = k3_phase(smi, p, frames, info)
    if not ok3c:
        return 1

    # ---- 3d. K3's 3-dof mode against its plain version, on phase 10's
    # fixture ----------------------------------------------------------------
    vi_dir, pos_true, write_s = write_fixture()
    k3v, ok3d = k3v_phase(smi, vi_dir, info)
    if not ok3d:
        return 1

    # ---- 3e. K4 against its plain version -------------------------------
    k4, ok3e = k4_phase(smi, p, frames, info)
    if not ok3e:
        return 1

    # ---- 3f. K5 against its plain versions ------------------------------
    k5, ok3f = k5_phase(smi, p, frames, info)
    if not ok3f:
        return 1

    # ---- 4. main path at full width -----------------------------------
    fe = VOFrontend(p, device="cuda")
    gpu_frames = torch.as_tensor(frames, device=dev)
    ts = [i / p.config_fps for i in range(N_FRAMES + N_SCAN)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    md0 = {k: obs.counters().get(k, 0) for k in ("md.match", "md.depth")}
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
    main_launches = read_launches()
    launches = main_launches["detect_candidates_cuda"]
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    pos = np.stack([o.nav.Pos.cpu().numpy() for o in outs])
    kl = [int(o.nav.kl_num) for o in outs]
    klm = [int(o.nav.klm_num) for o in outs]
    est = [bool(o.nav.estimation_ok) for o in outs]
    est_share = float(np.mean(est[2:]))
    md_main = {k: obs.counters().get(k, 0) - md0[k] for k in md0}
    ok4 = (bool(np.all(np.isfinite(pos))) and min(kl) >= KL_FLOOR
           and est_share >= 0.9 and launches == N_FRAMES
           and main_launches["minimizer_rv"] == N_FRAMES - 1
           and main_launches["minimizer_v"] == 0
           and main_launches["correct_and_augment"] == N_FRAMES - 1
           and main_launches["md_match"] == N_FRAMES - 1
           and main_launches["md_depth"] == N_FRAMES - 1
           and md_main == {"md.match": N_FRAMES - 1,
                           "md.depth": N_FRAMES - 1})
    steady = step_ms[5:]
    np.savez(os.path.join(OUT, "main_path.npz"), pos=pos, kl=kl, klm=klm,
             est=est, step_ms=step_ms)
    emit({"phase": "main_path", "ok": ok4, "frames": N_FRAMES,
          "launches": main_launches, "kl_min": min(kl),
          "k3_launches_expected": N_FRAMES - 1,
          "k4_launches_expected": N_FRAMES - 1,
          "k5_launches_expected": N_FRAMES - 1, "md_counters": md_main,
          "kl_floor": KL_FLOOR,
          "klm_min": min(klm), "est_ok_share_after_2": est_share,
          "pos_finite": bool(np.all(np.isfinite(pos))),
          "ms_per_frame_median": statistics.median(steady),
          "ms_per_frame_min": min(steady), "warmup_frames": 5,
          "timing": "host clock around step + synchronize",
          "peak_device_mb": peak_mb, "card": smi})
    if not ok4:
        return 1
    state4 = clone_tree(state)

    # ---- 5. where the step's time goes -------------------------------
    _, prof = profile_steps(fe, state, gpu_frames[N_FRAMES:N_FRAMES +
                                                  N_PROFILE],
                            ts[N_FRAMES:N_FRAMES + N_PROFILE])
    busy = prof["device_busy_ms_per_step"]
    emit({"phase": "profile", **prof,
          "device_idle_share": 1.0 - busy / statistics.median(steady),
          "idle_share_of": "median unprofiled ms/frame of phase 4",
          "card": smi})

    # ---- 4b. step_scan's CUDA graphs against the per-frame step ----------
    sc_f = gpu_frames[N_FRAMES:N_FRAMES + N_SCAN]
    sc_t = torch.tensor(ts[N_FRAMES:N_FRAMES + N_SCAN], dtype=torch.float32,
                        device=dev)
    st = clone_tree(state4)
    ref = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(N_SCAN):
        st, out = fe.step(st, sc_f[i], sc_t[i])
        ref.append(out)
    torch.cuda.synchronize()
    pf_ms = (time.perf_counter() - t0) * 1e3 / N_SCAN
    ref_state = st
    # the same frames through eager steps with the stage's plain versions
    st, ref_plain = clone_tree(state4), []
    with plain_stage():
        for i in range(N_SCAN):
            st, out = fe.step(st, sc_f[i], sc_t[i])
            ref_plain.append(out)
    ref_plain_state = st
    ref_pos = np.stack([o.nav.Pos.cpu().numpy() for o in ref])
    ref_kl = [int(o.nav.kl_num) for o in ref]
    tol4b = pos_tolerance(ref_pos)
    torch.cuda.reset_peak_memory_stats()
    scan, ok4b = {}, True
    for n in (8, 2):
        fe.step_scan(clone_tree(state4), sc_f[:n], sc_t[:n])   # capture
        st = clone_tree(state4)
        torch.cuda.synchronize()
        zero_launches()
        souts = []
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for c in range(N_SCAN // n):
                st, o = fe.step_scan(st, sc_f[c * n:(c + 1) * n],
                                     sc_t[c * n:(c + 1) * n])
                souts.append(o)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / N_SCAN
        got = read_launches()
        spos = torch.cat([o.nav.Pos for o in souts]).cpu().numpy()
        skl = torch.cat([o.nav.kl_num for o in souts]).cpu().tolist()
        dpos = float(np.abs(spos - ref_pos).max())
        k1_per = got["detect_candidates_cuda"] / (N_SCAN // n)
        k3_per = got["minimizer_rv"] / (N_SCAN // n)
        k4_per = got["correct_and_augment"] / (N_SCAN // n)
        k5_per = [got["md_match"] / (N_SCAN // n),
                  got["md_depth"] / (N_SCAN // n)]
        # state and outputs bit for bit against the eager steps, K5's and
        # the plain stage's
        scan_outs = [torch.cat(xs)
                     for xs in zip(*[tree_leaves(o) for o in souts])]
        differing = {
            label: [leaves_differing(st, rs),
                    leaves_differing(scan_outs, [
                        torch.stack(xs)
                        for xs in zip(*[tree_leaves(o) for o in ro])])]
            for label, rs, ro in (("eager", ref_state, ref),
                                  ("eager_plain_stage", ref_plain_state,
                                   ref_plain))}
        ok_n = (skl == ref_kl and dpos <= tol4b and k1_per == n
                and k3_per == n and got["minimizer_v"] == 0
                and k4_per == n and k5_per == [n, n]
                and all(d == [0, 0] for d in differing.values()))
        ok4b = ok4b and ok_n
        scan[f"n{n}"] = {"ok": ok_n, "replays": N_SCAN // n,
                         "ms_per_frame": ms, "kl_equal": skl == ref_kl,
                         "max_abs_pos_diff": dpos, "launches": got,
                         "k1_launches_per_replay": k1_per,
                         "k3_launches_per_replay": k3_per,
                         "k4_launches_per_replay": k4_per,
                         "k5_launches_per_replay": k5_per,
                         "state_output_leaves_differing": differing}
    peak_graph_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # one N=8 replay under torch.profiler: the device's busy time per
    # frame inside the graph, and so its idle share on the graph path
    st, _ = fe.step_scan(clone_tree(state4), sc_f[:8], sc_t[:8])
    _, acts = _device_timeline(_profiled(
        lambda: fe.step_scan(st, sc_f[8:], sc_t[8:])))
    busy8 = sum(a[1] - a[0] for a in acts) / 1e3 / 8
    replay = {"device_activities_per_frame": len(acts) / 8,
              "device_busy_ms_per_frame": busy8 if acts else None,
              "device_idle_share": (1.0 - busy8 / scan["n8"]["ms_per_frame"]
                                    if acts else None)}
    emit({"phase": "scan", "ok": ok4b, "frames": N_SCAN,
          "per_frame_ms": pf_ms, **scan, "tolerance": tol4b,
          "peak_device_mb_with_graphs": peak_graph_mb,
          "replay_profile_n8": replay,
          "timing": "host clock around the 16 frames + synchronize; "
                    "idle share against n8's unprofiled ms_per_frame",
          "card": smi})
    if not ok4b:
        return 1

    # ---- 6. run_vo entry point ----------------------------------------
    from rebvo_tpu_torch.apps import run_vo
    tum = {}
    for label, extra in (("run_vo", []), ("run_vo_chunk", ["--chunk", "8"])):
        zero_launches()
        rv_dir = os.path.join(OUT, label)
        run_vo.main(["--render", "40", "--max-frames", "40", "--out-dir",
                     rv_dir] + extra)
        got = read_launches()
        with open(os.path.join(rv_dir, p.TrayFile)) as fh:
            rows = [ln for ln in fh if ln.strip()]
        tum[label] = np.loadtxt(os.path.join(rv_dir, p.TrayFile))
        ok5 = (len(rows) == 39 and bool(np.all(np.isfinite(tum[label])))
               and got["detect_candidates_cuda"] > 0)
        line = {"phase": label, "ok": ok5, "tum_rows": len(rows),
                "expected_rows": 39, "launches": got}
        if extra:
            # 6b: the chunked run against the per-frame one (phase 7's bar)
            ppos, cpos = tum["run_vo"][:, 1:4], tum[label][:, 1:4]
            tol = pos_tolerance(ppos)
            dpos = float(np.abs(cpos - ppos).max())
            ok5 = ok5 and dpos <= tol
            line.update(ok=ok5, max_abs_pos_diff=dpos, tolerance=tol)
        emit(line)
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
    tol = pos_tolerance(cpu_pos)
    dpos = float(np.abs(cpu_pos - pos[:N_CPU - 1]).max())
    ok6 = cpu_kl == kl[:N_CPU - 1] and dpos <= tol
    emit({"phase": "cpu_vs_card", "ok": ok6, "frames": N_CPU,
          "kl_cpu": cpu_kl, "kl_card": kl[:N_CPU - 1],
          "max_abs_pos_diff": dpos, "tolerance": tol})
    if not ok6:
        return 1

    # ---- 8. the bench, in this process ----------------------------------
    from rebvo_tpu_torch import bench
    zero_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main()
    bench_launches = read_launches()
    bench_line = buf.getvalue().strip().splitlines()[-1]
    print(bench_line, flush=True)
    with open(os.path.join(OUT, "bench.json"), "w") as fh:
        fh.write(bench_line + "\n")
    bench_res = json.loads(bench_line)
    fps = bench_res["value"]
    batched = [bench_res["detail"].get(k) for k in ("batched_fps",
                                                      "batched_fps_nokf")]
    ok8 = (rc == 0 and bench_launches["build_scale_space_cuda"] > 0
           and np.isfinite(fps) and fps > 0
           and all(isinstance(v, float) and v > 0 for v in batched)
           and "not ported" not in bench_line)
    emit({"phase": "bench", "ok": ok8, "rc": rc, "launches": bench_launches})
    if not ok8:
        return 1

    # ---- 10-10d. the visual-inertial EuRoC path -------------------------
    vi_launches, ok10 = vi_path(smi, vi_dir, pos_true, write_s)
    if not ok10:
        return 1

    # ---- 11-11d. the stereo EuRoC path, 11e. VOSystem --------------------
    st_launches, ok11 = stereo_path(smi, vi_dir, pos_true)
    if not ok11:
        return 1
    sys_launches, ok11e = vosystem_phase(smi, p, gpu_frames, ts, pos)
    if not ok11e:
        return 1

    # ---- 12. offline BA, 12b. one parity row -----------------------------
    if not ba_phase(smi):
        return 1
    parity_k1, ok12b = parity_phase(smi)
    if not ok12b:
        return 1

    # ---- 13. the batched step, 13b. run_batch, 14. distributed ------------
    batched_launches, k1_b16, ok13 = batched_phase(smi, p, kw)
    if not ok13:
        return 1
    if not run_batch_phase(smi):
        return 1
    if not distributed_phase(smi, os.path.join(
            "build", "smoke_parity", "loop", "repo_out", "kf_list.npz")):
        return 1

    # ---- 15. telemetry, depth filler, surface, visualizer, video,
    # interactive, checkpoints -------------------------------------------
    m13_k1, ok15 = m13_phase(smi, p, gpu_frames, ts)
    if not ok15:
        return 1

    # ---- 9. kernel list -----------------------------------------------
    emit({"kernels": [{
        "name": "detect_candidates", "route": "cuda",
        "source": "rebvo_tpu_torch/csrc/detect_candidates.cu",
        "replaces": "rebvo_tpu/kernels/pallas_scale_space.py:225",
        "replaces_function": "detect_candidates_pallas (_detect_kernel)",
        "launches": launches, "mask_mismatch": worst_mism,
        "max_abs_err": worst_err, "max_abs_err_all_pixels": worst_all,
        "ms": kernel_ms, "kernel_ms": kernel_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "x_bound": kernel_ms / bound_ms, "resources": k1_res,
        "library_ms": None, "batch16": k1_b16,
        "launches_by_path": {
            "main_path": launches,
            "scan_n8": scan["n8"]["launches"]["detect_candidates_cuda"],
            "scan_n2": scan["n2"]["launches"]["detect_candidates_cuda"],
            "bench": bench_launches["detect_candidates_cuda"],
            "vi_main": vi_launches["vi_main"]["detect_candidates_cuda"],
            "vi_scan_n8": vi_launches["vi_scan"]["detect_candidates_cuda"],
            "vi_run_vo": vi_launches["vi_run_vo"][
                "detect_candidates_cuda"],
            **{k: v["detect_candidates_cuda"]
               for k, v in st_launches.items()},
            "vosystem": sys_launches["detect_candidates_cuda"],
            "parity_row": parity_k1,
            "batched": batched_launches["detect_candidates_cuda"],
            "m13_telemetry": m13_k1}}, {
        "name": "build_scale_space", "route": "cuda",
        "source": "rebvo_tpu_torch/csrc/build_scale_space.cu",
        "replaces": "rebvo_tpu/kernels/pallas_scale_space.py:276",
        "replaces_function": "build_scale_space_pallas (_sspace_kernel)",
        "launches": bench_launches["build_scale_space_cuda"],
        "max_abs_err": worst2, "ms": kernel2_ms, "kernel_ms": kernel2_ms,
        "call_ms": call2_ms, "plain_ms": plain2_ms, "bound_ms": bound2_ms,
        "bound_by": bound2_by, "x_bound": kernel2_ms / bound2_ms,
        "resources": k2_res, "library_ms": None,
        "launches_by_path": {
            "main_path": main_launches["build_scale_space_cuda"],
            "bench": bench_launches["build_scale_space_cuda"],
            "vi_main": vi_launches["vi_main"]["build_scale_space_cuda"],
            "stereo_main": st_launches["stereo_main"][
                "build_scale_space_cuda"]}}, {
        "name": "pose_lm", "route": "cuda",
        "source": "rebvo_tpu_torch/csrc/pose_lm.cu",
        "replaces": None,
        "replaces_function": "none: minimizer_rv's PyTorch ops "
                             "(kernels/pose_solver.minimizer_rv_plain)",
        "launches": main_launches["minimizer_rv"], **k3,
        "ms": k3["kernel_ms"], "bound_by": "bytes", "library_ms": None,
        "launches_by_path": {
            "main_path": main_launches["minimizer_rv"],
            "scan_n8": scan["n8"]["launches"]["minimizer_rv"],
            "scan_n2": scan["n2"]["launches"]["minimizer_rv"],
            "bench": bench_launches["minimizer_rv"],
            "vi_main": vi_launches["vi_main"]["minimizer_rv"],
            "vi_scan_n8": vi_launches["vi_scan"]["minimizer_rv"],
            "vi_run_vo": vi_launches["vi_run_vo"]["minimizer_rv"],
            **{k: v["minimizer_rv"] for k, v in st_launches.items()},
            "vosystem": sys_launches["minimizer_rv"],
            "batched": batched_launches["minimizer_rv"]}}, {
        "name": "pose_lm (3-dof mode, pose_lm_kernel<3>)", "route": "cuda",
        "source": "rebvo_tpu_torch/csrc/pose_lm.cu",
        "replaces": None,
        "replaces_function": "none: minimizer_v's PyTorch ops "
                             "(kernels/pose_solver.minimizer_v_plain)",
        "launches": vi_launches["vi_main"]["minimizer_v"], **k3v,
        "ms": k3v["kernel_ms"], "bound_by": "bytes", "library_ms": None,
        "launches_by_path": {
            "main_path": main_launches["minimizer_v"],
            "vi_main": vi_launches["vi_main"]["minimizer_v"],
            "vi_scan_n8": vi_launches["vi_scan"]["minimizer_v"],
            "vi_run_vo": vi_launches["vi_run_vo"]["minimizer_v"],
            **{k: v["minimizer_v"] for k, v in st_launches.items()},
            "vosystem": sys_launches["minimizer_v"],
            "batched": batched_launches["minimizer_v"]}}, {
        "name": "kf_correct", "route": "cuda",
        "source": "rebvo_tpu_torch/csrc/kf_correct.cu",
        "replaces": None,
        "replaces_function": "none: correct_and_augment's K-wide PyTorch "
                             "ops (frontend/kf_tracking._body_plain)",
        "launches": main_launches["correct_and_augment"], **k4,
        "ms": k4["kernel_ms"], "bound_by": "bytes", "library_ms": None,
        "launches_by_path": {
            "main_path": main_launches["correct_and_augment"],
            "scan_n8": scan["n8"]["launches"]["correct_and_augment"],
            "scan_n2": scan["n2"]["launches"]["correct_and_augment"],
            "bench": bench_launches["correct_and_augment"],
            "vi_main": vi_launches["vi_main"]["correct_and_augment"],
            "vi_scan_n8": vi_launches["vi_scan"]["correct_and_augment"],
            "vi_run_vo": vi_launches["vi_run_vo"]["correct_and_augment"],
            **{k: v["correct_and_augment"] for k, v in st_launches.items()},
            "vosystem": sys_launches["correct_and_augment"],
            "batched": batched_launches["correct_and_augment"]}}, {
        "name": "match_depth (md_match_kernel + md_depth_kernel)",
        "route": "cuda", "source": "rebvo_tpu_torch/csrc/match_depth.cu",
        "replaces": None,
        "replaces_function": "none: vo.match_depth's K-wide PyTorch ops "
                             "(kernels/match_depth.match_plain, "
                             "depth_plain)",
        "launches": [main_launches["md_match"], main_launches["md_depth"]],
        **k5, "ms": k5["kernel_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launches_by_path": {
            k: [v["md_match"], v["md_depth"]] for k, v in (
                ("main_path", main_launches),
                ("scan_n8", scan["n8"]["launches"]),
                ("scan_n2", scan["n2"]["launches"]),
                ("bench", bench_launches),
                ("vi_main", vi_launches["vi_main"]),
                ("vi_scan_n8", vi_launches["vi_scan"]),
                ("vi_run_vo", vi_launches["vi_run_vo"]),
                *st_launches.items(), ("vosystem", sys_launches),
                ("batched", batched_launches))}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
