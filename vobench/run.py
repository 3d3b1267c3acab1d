"""Run one cell of the benchmark and print its result as one JSON line.

    python -m vobench.run --workload NAME --seed N --seconds S --trace 0|1

BENCHMARK.json (the repository root) names the cell: its configuration
(vobench/configs/<config>.json, the program's parameters as run) and
its traffic (vobench/traffic/<traffic>.json, read by the one generator
in vobench/scene.py and driven by vobench/runners/<runner>.py). The run

  1. makes the inputs from --seed on the card: one period of 8-bit
     camera frames per lane (with StereoAvaiable, cam1's frames of the
     same period as well; visual-inertial, the IMU samples);
  2. builds the program (rebvo_tpu_torch) and warms up every shape the
     traffic uses: set-up, timed from the process start to the first
     timed frame (setup_s);
  3. drives the traffic for --seconds in a closed loop, each unit's nav
     outputs read back to the host; with --trace 1, a steady stretch of
     units runs under torch.profiler and the per-layer metrics are read
     from it (vobench/metrics/<name>.py), else the end-to-end metrics
     (vobench/end_to_end/<name>.py);
  4. after the window: reads the peak device memory, steps the same
     objects on through a few more units, spaced as the seed draws, and
     copies each checked unit's state before and after it and its
     outputs to the host; frees the program; and holds those units (and
     the state set-up reached) against the plain reference
     (vobench/check.py) with the cell's limits
     (vobench/limits/<cell>.json).

It exits with 2 and prints no result without a CUDA device (or with
fewer than the cell asks for), with 3 when the program cannot be
imported, and with 4 when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, NamedTuple, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "vobench"
FORBIDDEN = ("jax", "jaxlib", "flax", "rebvo_tpu")
PROGRAM = "rebvo_tpu_torch"


def set_process(root: Path = ROOT) -> None:
    """Before torch is imported: every build and kernel cache inside the
    checkout, at fixed paths (the program builds its kernels under
    build/kernels itself), and one host thread for the math libraries,
    so that one run loads the host's cores as little and as evenly as it
    can (a one-card machine shares its host's cores)."""
    cache = root / "build" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    import torch
    torch.set_num_threads(1)


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"vobench: no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path):
    """A module from a file under vobench/ (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "vobench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    wl = find(bench["workloads"], name, "workload")
    cfg_entry = find(bench["configs"], wl["config"], "configuration")
    return Cell(bench, wl, load_json(root / cfg_entry["file"]),
                load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"))


class Context(NamedTuple):
    """What a runner is given: the program's parameters, the traffic,
    the inputs made from the seed (on the host), and the frame clock.
    A runner also leaves `parts`, the seconds of its set-up's steps."""

    params: object               # the program's REBVOParameters
    traffic: dict
    device: object
    host: object                 # [L, P, H, W] float32 frames as handed
    imu_rows: Optional[object]   # [S, 7] EuRoC IMU rows, or None
    hold: int                    # still frames before the path starts
    period: int                  # frames in one period of the path
    phases: List[int]            # each lane's starting period frame
    fps: float
    t0: float
    host_pair: Optional[object] = None   # cam1's [L, P, H, W] as `host`

    def t(self, i: int) -> float:
        """Time stamp (s) of run frame i."""
        return self.t0 + i / self.fps

    def idx(self, lane: int, i: int) -> int:
        """The period frame that lane `lane` shows at run frame i."""
        from vobench.scene import frame_index
        return frame_index(i, self.hold, self.period, self.phases[lane])


class Inputs(NamedTuple):
    """The traffic's inputs, rendered on the device."""

    frames: object               # [L, P, H, W] uint8, cam0
    imu: Optional[object]        # [S, 7] EuRoC IMU rows, or None
    hold: int
    period: int
    phases: List[int]
    pair: Optional[object]       # [L, P, H, W] uint8, cam1 (stereo), or None


def make_inputs(params_dict: dict, traffic: dict, seed: int,
                device) -> Inputs:
    """The traffic's inputs, rendered on `device`. With StereoAvaiable
    each lane's cam1 period is rendered too: the same scene seen from
    cam1's poses (the configuration's cam0 -> cam1 extrinsics), through
    cam1's own intrinsics and distortion."""
    import numpy as np
    import torch

    from vobench import scene
    from vobench.reference.config import REBVOParameters
    from vobench.reference.core.geometry import CameraModel
    p = REBVOParameters(**params_dict)
    cam = CameraModel.from_params(p)
    spec = scene.PathSpec.from_traffic(traffic)
    period = scene.period_frames(spec, p.config_fps)
    lanes = traffic.get("lanes", 1)
    hold = p.InitBiasFrameNum + 2 if traffic.get("still_start") else 0
    pos, rot = scene.period_poses(spec, p.config_fps)
    rm = scene.resample_map(cam)
    frames = torch.stack([
        scene.camera_frames(scene.scene_seed(seed, b), pos, rot, cam, device,
                            rm)
        for b in range(lanes)])
    imu = None
    if "imu" in traffic:
        im = traffic["imu"]
        rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
        n = traffic["max_frames"]
        imu = scene.imu_samples(
            spec, hold / p.config_fps, -0.1, (n + 1) / p.config_fps,
            traffic["t0"], im["gyro_noise_density"],
            im["accel_noise_density"], rng)
    pair = None
    if p.StereoAvaiable:
        cam1 = CameraModel.from_params(p, stereo=True)
        rm1 = scene.resample_map(cam1)
        pos1, rot1 = scene.pair_poses(*p.stereo_extrinsics(), pos, rot)
        pair = torch.stack([
            scene.camera_frames(scene.scene_seed(seed, b), pos1, rot1, cam1,
                                device, rm1)
            for b in range(lanes)])
    return Inputs(frames, imu, hold, period,
                  scene.lane_phases(lanes, period), pair)


class Reading(NamedTuple):
    """What a metric reader is given."""

    window_s: float              # the timed window
    frames: int                  # lane-frames whose outputs reached the host
    latencies: List[float]       # per frame, s (closed loop, live cells)
    setup_s: float
    units: int
    trace: Optional[object]      # vobench.trace.TraceSummary
    traced_frames: int
    traced_units: int
    height: int
    width: int
    extras: dict
    images_per_frame: int = 1    # camera images a lane-frame (stereo: 2)


def check_spacing(seed: int, traffic: dict) -> List[int]:
    """How many unchecked units run before each checked one, once the
    window has closed: drawn from the seed, 0 to spacing - 1 each."""
    import numpy as np
    chk = traffic["check"]
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 11])
    return [int(x) for x in rng.integers(0, chk["spacing"], chk["units"])]


class Run(NamedTuple):
    """What one drive of a cell leaves for the check and the metrics."""

    cell: Cell
    params_dict: dict
    device: object
    frames_u8: object            # [L, P, H, W] the inputs, host
    imu: Optional[object]
    start_state: dict            # the program's state after set-up
    start_frames: list           # the frames set-up stepped, per lane
    units: list                  # the sampled units (vobench.check.Unit)
    reading: Reading
    failed: int
    memory_peak_bytes: int
    setup_parts: Dict[str, float]
    frames_pair_u8: Optional[object] = None   # cam1's [L, P, H, W], or None


def drive(name: str, seed: int, seconds: float, trace: bool, device,
          root: Path = ROOT, params_update: Optional[dict] = None,
          traffic_update: Optional[dict] = None,
          t_start: float = T_START) -> Run:
    """Set up cell `name` from `seed` and drive it for `seconds`;
    `params_update` and `traffic_update` replace entries of the
    configuration's parameters and of the traffic (tests run small sizes
    on the CPU through them)."""
    import torch

    from vobench import check
    from vobench import trace as tr

    cell = load_cell(name, root)
    cell = cell._replace(traffic=dict(cell.traffic, **(traffic_update or {})))
    params_dict = dict(cell.config["params"], **(params_update or {}))
    from rebvo_tpu_torch.config import REBVOParameters
    params = REBVOParameters(**params_dict)
    device = torch.device(device)
    on_cuda = device.type == "cuda"

    t_in = time.perf_counter()
    inp = make_inputs(params_dict, cell.traffic, seed, device)
    imu, hold, period, phases = inp.imu, inp.hold, inp.period, inp.phases
    # the frames as the program's dataset reader hands them (8 bits x 3)
    host = (inp.frames.to(torch.float32) * 3.0).cpu()
    frames_u8 = inp.frames.cpu()
    host_pair = pair_u8 = None
    if inp.pair is not None:
        host_pair = (inp.pair.to(torch.float32) * 3.0).cpu()
        pair_u8 = inp.pair.cpu()
    del inp
    if on_cuda:     # the peak is the program's: from here on
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_prog = time.perf_counter()
    ctx = Context(params, cell.traffic, device, host, imu, hold,
                  period, phases, params.config_fps, cell.traffic["t0"],
                  host_pair)
    drv = load_module(HERE / "runners" /
                      f"{cell.traffic['runner']}.py").Runner(ctx)
    drv.setup()
    parts = {"start_s": t_in - t_start, "inputs_s": t_prog - t_in,
             **drv.parts}
    start_state = drv.state()
    start_frames = drv.start_frames()
    tr_cfg = cell.traffic["trace"]
    tr_from, tr_to = tr_cfg["from_unit"], tr_cfg["from_unit"] + tr_cfg["units"]
    prof = traced = window_span = None
    frames_done = failed = traced_frames = 0
    lat: List[float] = []
    unit_s: List[float] = []

    if on_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0
    it = 0
    while t_end - t0 < seconds:
        if trace and it == tr_from:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            window_span = record_function(tr.WINDOW_SPAN)
            window_span.__enter__()
        t_unit = time.perf_counter()
        n, n_ok, lt = drv.run_unit(it)
        t_end = time.perf_counter()
        unit_s.append(t_end - t_unit)
        frames_done += n
        failed += n - n_ok
        if lt:
            lat.extend(lt)
        if prof is not None:
            traced_frames += n
        it += 1
        if prof is not None and it == tr_to:
            window_span.__exit__(None, None, None)
            if on_cuda:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            traced, prof = prof, None
    window_s = t_end - t0
    if trace and traced is None:
        raise RuntimeError(f"the window ended at unit {it}, before the "
                           f"traced units {tr_from}..{tr_to - 1}")
    summary = (tr.summarize(traced.profiler.kineto_results.events())
               if trace else None)
    extras = drv.extras(range(tr_from, tr_to)) if trace else {}
    mem_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    # the window has closed: the same objects step on through the same
    # entry, and the checked units are copied to the host around them
    units: List[check.Unit] = []
    for skip in check_spacing(seed, cell.traffic):
        for _ in range(skip):
            drv.run_unit(it)
            it += 1
        before = drv.state()
        drv.run_unit(it)
        fr, t_prev = drv.unit(it)
        units.append(check.Unit(fr, t_prev, before, drv.state(),
                                drv.outputs()))
        it += 1
    drv.close()
    del drv, ctx, host, host_pair
    if on_cuda:
        torch.cuda.empty_cache()
    extras["unit_s"] = unit_s
    reading = Reading(window_s, frames_done, lat, setup_s, len(unit_s),
                      summary,
                      traced_frames, tr_cfg["units"], params.ImageHeight,
                      params.ImageWidth, extras,
                      1 + int(bool(params.StereoAvaiable)))
    return Run(cell, params_dict, device, frames_u8, imu, start_state,
               start_frames, units, reading, failed, mem_peak, parts,
               pair_u8)


def correctness(run: Run, variant: Optional[str] = None):
    """(numbers, note): the gaps between the program's state after
    set-up and the reference's from the initial state, and between each
    checked unit and the reference stepped from the unit's state before
    it. With `variant` ("bf16", the control; "nudge", a sound change's
    stand-in: vobench.check.Reference) the reference so changed stands
    in the program's place. A stereo run's cam1 frames go to both."""
    from vobench import check
    system = any(k.startswith("sys.") for k in run.start_state)
    ref = check.Reference(run.params_dict, run.device, run.frames_u8,
                          run.imu, system=system,
                          frames_pair=run.frames_pair_u8)
    alt = (check.Reference(run.params_dict, run.device, run.frames_u8,
                           run.imu, variant=variant, system=system,
                           frames_pair=run.frames_pair_u8)
           if variant else None)
    start = (check.reference_start(alt, run.start_frames) if alt
             else run.start_state)
    readings = [check.gaps(start, check.reference_start(ref,
                                                        run.start_frames))]
    for u in run.units:
        after, outs = check.reference_unit(ref, u)
        if alt is None:
            got = {**u.after, **u.outs}
        else:
            a_after, a_outs = check.reference_unit(alt, u)
            got = {**a_after, **a_outs}
        readings.append(check.gaps(got, {**after, **outs}))
    return check.worst(readings), ("" if run.units else
                                   "no unit was checked")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             **kw) -> dict:
    """One run of cell `name`: the result object the command prints."""
    from vobench import trace as tr
    run = drive(name, seed, seconds, trace, device, **kw)
    t_chk = time.perf_counter()
    numbers, note = None, ""
    try:
        numbers, note = correctness(run)
    except Exception:                                     # noqa: BLE001
        note = traceback.format_exc()
    check_s = time.perf_counter() - t_chk
    from vobench import check
    ok = (numbers is not None and not note
          and check.judge(numbers, run.cell.limits))
    r = run.reading
    result = {"correct": bool(ok), "attempted": r.frames,
              "failed": run.failed,
              "metrics": read_metrics(run.cell, r, trace),
              "device": device_info(run.device, r.trace,
                                    run.memory_peak_bytes)}
    if r.trace is not None:
        result["breakdown"] = {"device_ops": tr.top(r.trace.ops),
                               "idle_gaps": tr.top(r.trace.gaps)}
    from vobench.stats import percentile
    us = r.extras.get("unit_s") or [0.0]
    result["run"] = {"units": r.units, "units_checked": len(run.units),
                     "check_s": check_s, "window_s": r.window_s,
                     "setup_s": r.setup_s, "setup_parts": run.setup_parts,
                     "unit_ms": {q: percentile(us, q) * 1e3
                                 for q in (5, 25, 50, 75, 95)}}
    if r.latencies:
        q = len(r.latencies) // 4
        result["run"]["latency_ms"] = {
            "deciles": [percentile(r.latencies, d) * 1e3
                        for d in range(10, 100, 10)],
            "max": max(r.latencies) * 1e3,
            "p50_by_quarter": [percentile(r.latencies[i * q:(i + 1) * q], 50)
                               * 1e3 for i in range(4)] if q else []}
    if note:
        result["run"]["check_note"] = note[-1500:]
    result["checks"] = {k: {"value": (numbers or {}).get(k), "limit": lim}
                        for k, lim in run.cell.limits.items()}
    return result


def _applies(metric: dict, cell_name: str, e2e_names: List[str]) -> bool:
    """A per-layer metric is read in the cells its `workloads` lists, or,
    without that key, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric["moves"] in e2e_names


def read_metrics(cell: Cell, reading: Reading, trace: bool) -> dict:
    """The cell's end-to-end metrics (--trace 0) or per-layer metrics
    (--trace 1), each from its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    name = cell.workload["name"]
    e2e = [m for m in cell.bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    chosen = (
        [(m, HERE / "metrics" / f"{m['name']}.py")
         for m in cell.bench["per_layer"]
         if _applies(m, name, [x["name"] for x in e2e])]
        if trace else
        [(m, HERE / "end_to_end" / f"{m['name']}.py") for m in e2e])
    out = {}
    for m, path in chosen:
        v = load_module(path).read(reading)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_info(device, summary, memory_peak_bytes: int) -> dict:
    import torch
    gpu = device.type == "cuda"
    info = {"platform": "gpu" if gpu else "cpu",
            "kind": torch.cuda.get_device_name(device) if gpu else "cpu",
            "count": 1, "memory_peak_bytes": memory_peak_bytes}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_process()
    cell = load_cell(args.workload)
    import torch
    need = cell.workload["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"vobench: the cell {args.workload} needs {need} CUDA "
              f"device(s), {have} visible; no result", file=sys.stderr)
        return 2
    try:
        import rebvo_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"vobench: the program {PROGRAM} cannot be imported ({e}); "
              f"no result", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    result["device"]["power_limit"] = card()
    bad = forbidden_modules()
    if bad:
        print(f"vobench: loaded in this process: {', '.join(bad)}; no "
              f"result", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
