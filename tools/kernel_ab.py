"""Device times of the scale-space kernels K1 and K2 of two source trees of
the PyTorch port, on one card, in turns (other, this, this, other).

    python3 tools/kernel_ab.py --other DIR [--calls 200]

DIR is the root of another checkout, for example an unpacked `git archive`
of an earlier commit under the git-ignored `build/`. Each turn is a
process of its own that puts its tree first on the path, so that it builds
the kernels with that tree's `cuda_build` (into the tree's `build/kernels/`)
and launches them through that tree's wrappers (`detect_candidates_cuda`,
`build_scale_space_cuda`; their signatures have not changed since K2 came
in). Each turn times both kernels with
`chip_smoke.device_ms` (this tree's, imported over the turn's package:
median CUPTI device time per call, L2 flushed before each) on a rendered
480x752 frame and a uniform random one, and saves the outputs; the two
trees' outputs must be equal bit for bit. Prints one JSON line; needs the
card. Imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TURNS = ("other", "this", "this", "other")


def worker(tree: Path, save: Path, calls: int) -> None:
    """One turn: time K1 and K2 of `tree` and save their outputs."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from rebvo_tpu_torch.config import REBVOParameters
    from rebvo_tpu_torch.io.render import render_lateral
    from rebvo_tpu_torch.kernels import cuda_scale_space as cs
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    dev = torch.device("cuda")
    p = REBVOParameters()
    kw = dict(sigma0=p.Sigma0, k_sigma=p.KSigma,
              win_s=p.DetectorPlaneFitSize, per_hist=p.DetectorPosNegThresh,
              dog_thresh=p.DetectorDoGThresh, max_img_value=765.0)
    frames = {"rendered": render_lateral(p, 6)[5],
              "uniform": np.random.default_rng(0).uniform(
                  0, 765, (p.ImageHeight, p.ImageWidth)).astype(np.float32)}
    th = torch.full((), p.DetectorThresh, dtype=torch.float32, device=dev)
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev).zero_
    res, outs = {"k1_us": {}, "k2_us": {}}, {}
    for name, frame in frames.items():
        x = torch.as_tensor(frame, device=dev)
        k1 = cs.detect_candidates_cuda(x, th, **kw)
        k2 = cs.build_scale_space_cuda(x, p.Sigma0, p.KSigma)
        outs[name] = [t.cpu() for t in (*k1, *k2)]
        res["k1_us"][name] = 1e3 * smoke.device_ms(
            lambda: cs.detect_candidates_cuda(x, th, **kw), calls, flush)
        res["k2_us"][name] = 1e3 * smoke.device_ms(
            lambda: cs.build_scale_space_cuda(x, p.Sigma0, p.KSigma), calls,
            flush)
    torch.save(outs, save)
    print(json.dumps(res))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.save, args.calls)
        return 0
    if args.other is None:
        ap.error("--other DIR is required")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    trees = {"other": args.other.resolve(), "this": ROOT}
    res = {"card": smi, "calls": args.calls, "k1_us": {}, "k2_us": {}}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        saved = {}
        for i, turn in enumerate(TURNS):
            saved[turn] = Path(tmp) / f"{turn}.pt"
            out = subprocess.run(
                [sys.executable, __file__, "--worker", str(trees[turn]),
                 "--save", str(saved[turn]), "--calls", str(args.calls)],
                capture_output=True, text=True, cwd=trees[turn])
            if out.returncode != 0:
                print(f"kernel_ab: turn {i} ({turn}) failed:\n{out.stderr}",
                      file=sys.stderr)
                return 1
            got = json.loads(out.stdout.strip().splitlines()[-1])
            for key in ("k1_us", "k2_us"):
                for frame, us in got[key].items():
                    res[key].setdefault(frame, {}).setdefault(
                        turn, []).append(us)
        a, b = (torch.load(saved[t]) for t in ("other", "this"))
    res["outputs_equal"] = {f: all(torch.equal(u, v)
                                   for u, v in zip(a[f], b[f])) for f in a}
    print(json.dumps(res))
    return 0 if all(res["outputs_equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
