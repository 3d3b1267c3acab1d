"""One traced run of a benchmark cell, in this process, and the program's
own records (rebvo_tpu_torch.obs) read against its trace (card only).

    env PYTHONPATH=. python3 tools/trace_cell.py euroc_mono.replay \\
        --seed 3141592031 [--seconds 40] [--dump trace.json]

Prints two JSON lines: the run (`correct`, the per-layer metrics, the
traced idle gaps by span, the device's busy and window seconds, the
counters), then the ring: each device stage's median ms a lane-frame,
the median over the run's steps of their stages' sum a lane-frame
(against `busy_ms_per_frame.replay`, the trace's busy union, which also
holds the frames' copies and undistortion outside the step), the same
sums of the traced units' steps (stretched by the profiler), and each
span's median host ms with and without the profiler recording.
`--dump` writes the ring as Chrome-trace JSON (obs.dump).
"""

from __future__ import annotations

import argparse
import json
import statistics


def ring_summary(units) -> dict:
    stages, sums, traced_sums, spans = {}, {}, {}, {}
    for u in units:
        recs = u.records
        traced = any(r.profiled for r in recs if r.device_ms is None)
        for r in recs:
            if r.device_ms is None:
                key = r.name + (" (profiled)" if r.profiled else "")
                spans.setdefault(key, []).append(r.ms)
                continue
            ms = r.device_ms / r.lanes
            stages.setdefault(r.name, []).append(ms)
            sums[r.frame] = sums.get(r.frame, 0.0) + ms
            if traced:
                traced_sums[r.frame] = traced_sums.get(r.frame, 0.0) + ms
    med = statistics.median
    return {"units": len(units),
            "stage_median_ms": {k: med(v) for k, v in stages.items()},
            "steps": len(sums),
            "stage_sum_median_ms": med(sums.values()) if sums else None,
            "traced_stage_sums_ms": sorted(traced_sums.values()),
            "span_median_ms": {k: med(v) for k, v in spans.items()},
            "span_count": {k: len(v) for k, v in spans.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    from vobench import run
    run.set_process()
    from rebvo_tpu_torch import obs
    r = run.run_cell(args.workload, args.seed, args.seconds, True, "cuda")
    print(json.dumps({
        "cell": args.workload, "seed": args.seed, "correct": r["correct"],
        "card": run.card(),
        "metrics": {k: v["value"] for k, v in r["metrics"].items()},
        "idle_gaps": r["breakdown"]["idle_gaps"],
        "busy_s": r["device"]["busy_s"], "window_s": r["device"]["window_s"],
        "counters": obs.counters()}), flush=True)
    print(json.dumps(ring_summary(obs.units())), flush=True)
    if args.dump:
        obs.dump(args.dump)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
