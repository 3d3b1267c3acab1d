"""The readings that the correctness limits are set from, on the card:
for each seed, drive a cell (its set-up and a short window at the
cell's own load, then the checked units as a run checks them), and read
the numbers against the plain reference of three things in turn: the
program; the control, the reference in the program's place with its
carried state and each frame rounded to bfloat16 (the configurations
state float32); and two stand-ins of a change that orders sums
otherwise: the reference with its float64 products and long sums added
in reverse order ("reorder"), and the reference with the control's
leaves and frames moved by one float32 ulp instead ("nudge"). Several
seeds share one process.

    python -m vobench.control --workload NAME --seeds 1,2,3 --seconds 6 \\
        [--out control.jsonl]

Prints one JSON line per seed: {"workload", "seed", "program": {...},
"control": {...}, "reorder": {...}, "nudge": {...}, "units_checked",
"seconds"}.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from vobench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.set_process()
    import torch
    if not torch.cuda.is_available():
        print("vobench.control: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in [int(x) for x in args.seeds.split(",")]:
            t0 = time.perf_counter()
            r = run.drive(args.workload, seed, args.seconds, False, "cuda",
                          t_start=t0)
            prog, note = run.correctness(r)
            line = {"workload": args.workload, "seed": seed,
                    "program": prog, "units_checked": len(r.units),
                    "setup_s": r.reading.setup_s,
                    "window_frames": r.reading.frames}
            line["control"], _ = run.correctness(r, "bf16")
            line["reorder"], _ = run.correctness(r, "reorder")
            line["nudge"], _ = run.correctness(r, "nudge")
            line["seconds"] = time.perf_counter() - t0
            if note:
                line["note"] = note
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            del r
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
