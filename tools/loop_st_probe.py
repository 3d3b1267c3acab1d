"""Where the card's `loop_st` parity row parts from the CPU (card only).

    python3 tools/loop_st_probe.py [--seq loop_st] [--frames 240]
        [--shadow-every 1 (0: none)] [--variants base,anchor64,lm64,all64]
        [--perturb 4] [--cpu-run] [--seq-dir DIR]
        [--out chiprun_out/loop_st_probe.json]

Renders the parity row (apps/parity.render_dataset, the JAX package's
seed) under build/loop_st_probe/ (or reads the one rendered in
`--seq-dir`, e.g. build/parity/loop_st from apps/parity) and steps it
with the parity config:

1. shadow: the card steps the row as run_vo does. At every
   `--shadow-every`-th frame one CPU step from the card's state runs
   beside the card's step, and the two are held against each other:
   VScaleC, Vel, Pos, and the outputs of the three candidate
   reductions, recorded inside the step (`anchor_scale_measure`, the
   long-baseline scale's IRLS normal equations; `velocity_scale_refine`,
   the per-frame scale's inlier medians; `minimizer_rv`, the LM normal
   equations). Each candidate is also recomputed on the CPU from the
   card's own inputs at that frame, so its gap is its own, not one
   carried in from an earlier stage. The first frame where a gap passes
   chip_smoke phase 11d's bar (Pos: 2% of the path plus 1e-4) or 1e-3
   relative (VScaleC, the anchor scale) is reported.
2. variants: the whole row on the card again with one candidate run in
   float64 (inputs widened, outputs narrowed back to float32), and its
   ATE against the rendered ground truth as apps/parity computes it.
   A candidate that carries the gap moves the ATE towards the CPU's.
3. perturbed: the whole row on the card from a state whose stereo
   scale integrator VScaleC starts at 1 + k * 1e-6 (k = 1..--perturb)
   instead of 1, a few float32 ulps: the spread of their ATEs is how far
   the row's ATE moves under a perturbation the size of a sum order.
4. `--cpu-run`: the whole row on the CPU, for its ATE.

Prints one JSON line and writes it to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rebvo_tpu_torch.apps import parity  # noqa: E402
from rebvo_tpu_torch.frontend import step as step_mod  # noqa: E402
from rebvo_tpu_torch.io.dataset import DatasetSequence  # noqa: E402
from rebvo_tpu_torch.io.logger import RunLogger  # noqa: E402
from rebvo_tpu_torch.io.trajectory import ate_rmse  # noqa: E402
from rebvo_tpu_torch.frontend.step import tree_map  # noqa: E402

CANDIDATES = ("anchor_scale_measure", "velocity_scale_refine",
              "minimizer_rv")
ORIG = {name: getattr(step_mod, name) for name in CANDIDATES}
VARIANTS = {"base": (), "anchor64": ("anchor_scale_measure",),
            "lm64": ("minimizer_rv",), "all64": CANDIDATES}
REL_BAR = 1e-3


def widen(x):
    return x.double() if isinstance(x, torch.Tensor) and \
        x.dtype == torch.float32 else x


def narrow(x):
    return x.float() if isinstance(x, torch.Tensor) and \
        x.dtype == torch.float64 else x


def to_cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


class Recorder:
    """Wraps the candidates in the step module: records each call's
    inputs and outputs while `on`, and runs the names in `f64` in
    float64."""

    def __init__(self):
        self.on = False
        self.calls = []
        self.f64 = set()
        for name in CANDIDATES:
            setattr(step_mod, name, self._wrap(name))

    def _wrap(self, name):
        fn = ORIG[name]

        def run(*args, **kw):
            if name in self.f64:
                out = tree_map(narrow, fn(*tree_map(widen, args),
                                          **{k: tree_map(widen, v)
                                             for k, v in kw.items()}))
            else:
                out = fn(*args, **kw)
            if self.on:
                self.calls.append((name, args, kw, out))
            return out
        return run

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def outputs(name, out):
    """The numbers compared of one candidate's result."""
    if name == "minimizer_rv":
        return {"Vel": out.Vel, "W0": out.W0, "score": out.score,
                "W_X": out.W_X}
    return {"s": out[0], "n_used": out[1]}


def gap(name, a, b):
    oa, ob = outputs(name, a), outputs(name, b)
    return {k: rel(oa[k].detach().cpu().numpy(),
                   ob[k].detach().cpu().numpy()) for k in oa}


def load_row(seq, n, seq_dir=None):
    seq_dir = seq_dir or os.path.join(ROOT, "build", "loop_st_probe", seq)
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(seq_dir, "gt_pos.txt")):
        os.makedirs(seq_dir, exist_ok=True)
        parity.render_dataset(seq_dir, seq, n, parity.seq_seed(seq))
    render_s = time.perf_counter() - t0
    kind, vi, dist, st = parity._parse_kind(seq)
    params = parity.parity_params(seq_dir, vi=vi, dist=dist, st=st)
    params = params.replace(NavLogCap=n + 8)
    items = [(t, np.asarray(f, np.float32), p) for t, f, _, p in
             list(DatasetSequence.from_params(params))[:n]]
    gt = np.loadtxt(os.path.join(seq_dir, "gt_pos.txt"))
    return params, items, gt, render_s


def ate(state, gt, n):
    rows = RunLogger.from_device_log(state.navlog, state.navlog_n).rows
    pos = np.stack([r["Pos"] for r in rows])
    warm = min(40, n // 4)
    return float(ate_rmse(parity._resample(pos, n)[warm:], gt[warm:],
                          with_scale=True))


def run_row(fe, items, dev, eps=0.0):
    def put(x):
        return None if x is None else torch.as_tensor(x).to(dev)
    t, f, pr = items[0]
    state = fe.bootstrap(fe.init(), put(f), t, put(pr))
    state = state._replace(VScaleC=state.VScaleC * (1.0 + eps))
    for t, f, pr in items[1:]:
        state, _ = fe.step_donated(state, put(f), t, put(pr))
    return state


def shadow(params, items, gt, rec, every):
    fe_g = step_mod.VOFrontend(params, device="cuda")
    fe_c = step_mod.VOFrontend(params, device="cpu")
    cuda = torch.device("cuda")
    t, f, pr = items[0]
    state = fe_g.bootstrap(fe_g.init(), torch.as_tensor(f).to(cuda), t,
                           torch.as_tensor(pr).to(cuda))
    frames, first, worst = [], {}, {}
    path = []
    for i, (t, f, pr) in enumerate(items[1:], start=1):
        fg = torch.as_tensor(f).to(cuda)
        pg = None if pr is None else torch.as_tensor(pr).to(cuda)
        rec.on = i % every == 0
        nxt, out_g = fe_g.step(state, fg, t, pg)
        calls_g = rec.take()
        path.append(out_g.nav.Pos.cpu().numpy())
        if rec.on:
            st_c = tree_map(to_cpu, state)
            nxt_c, out_c = fe_c.step(st_c, torch.as_tensor(f), t,
                                     None if pr is None
                                     else torch.as_tensor(pr))
            calls_c = rec.take()
            rec.on = False
            pos_tol = 0.02 * (float(np.linalg.norm(path[-1] - path[0])) +
                              float(np.linalg.norm(path[0]))) + 1e-4
            g = {"frame": i,
                 "VScaleC": rel(nxt.VScaleC.cpu(), nxt_c.VScaleC),
                 "Vel": rel(nxt.Vel.cpu(), nxt_c.Vel),
                 "Pos_abs": float(np.abs(out_g.nav.Pos.cpu().numpy() -
                                         out_c.nav.Pos.numpy()).max()),
                 "pos_tol": pos_tol,
                 "kl_num_equal": int(out_g.nav.kl_num) ==
                 int(out_c.nav.kl_num),
                 "stereo_num": [int(out_g.stereo_num),
                                int(out_c.stereo_num)]}
            # each candidate: the card's and the CPU step's outputs, and
            # the CPU recomputing it from the card's own inputs
            for (name, args, kw, og), (_, _, _, oc) in zip(calls_g,
                                                          calls_c):
                oc_same = ORIG[name](
                    *tree_map(to_cpu, args),
                    **{k: tree_map(to_cpu, v)
                       for k, v in kw.items()})
                g[name] = {"step_gap": gap(name, og, oc),
                           "same_input_gap": gap(name, og, oc_same)}
            by_g = {c[0]: c[3] for c in calls_g}
            by_c = {c[0]: c[3] for c in calls_c}
            if "anchor_scale_measure" in by_g:
                g["anchor_s"] = [float(by_g["anchor_scale_measure"][0]),
                                 float(by_c["anchor_scale_measure"][0])]
            for key, bar in (("VScaleC", REL_BAR), ("Pos_abs", pos_tol)):
                if key not in first and g[key] > bar:
                    first[key] = i
            for name in CANDIDATES:
                if name in g:
                    for k, v in g[name]["same_input_gap"].items():
                        w = worst.setdefault(name, {})
                        if v > w.get(k, (0.0, -1))[0]:
                            w[k] = (v, i)
                    a = g.get("anchor_s")
                    if name == "anchor_scale_measure" and a and \
                            "anchor_s" not in first and \
                            rel(a[0], a[1]) > REL_BAR:
                        first["anchor_s"] = i
            frames.append(g)
        state = nxt
    return {"frames_compared": len(frames), "first_parting_frame": first,
            "worst_same_input_gap": worst, "ate_card": ate(state, gt,
                                                           len(items)),
            "per_frame": frames}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", default="loop_st")
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--shadow-every", type=int, default=1)
    ap.add_argument("--variants", default="base,anchor64,lm64,all64")
    ap.add_argument("--perturb", type=int, default=4)
    ap.add_argument("--cpu-run", action="store_true")
    ap.add_argument("--seq-dir", default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "loop_st_probe.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("loop_st_probe: no CUDA device", file=sys.stderr)
        return 2
    params, items, gt, render_s = load_row(args.seq, args.frames,
                                           args.seq_dir)
    rec = Recorder()
    res = {"seq": args.seq, "frames": len(items), "render_s": render_s,
           "card": torch.cuda.get_device_name(0)}
    if args.shadow_every:
        t0 = time.perf_counter()
        res["shadow"] = shadow(params, items, gt, rec, args.shadow_every)
        res["shadow_s"] = time.perf_counter() - t0
    res["variants"] = {}
    for v in [x for x in args.variants.split(",") if x]:
        rec.f64 = set(VARIANTS[v])
        t0 = time.perf_counter()
        fe = step_mod.VOFrontend(params, device="cuda")
        state = run_row(fe, items, "cuda")
        res["variants"][v] = {"ate": ate(state, gt, len(items)),
                              "seconds": time.perf_counter() - t0}
        print(json.dumps({v: res["variants"][v]}), flush=True)
    rec.f64 = set()
    res["perturbed"] = {}
    for k in range(1, args.perturb + 1):
        state = run_row(step_mod.VOFrontend(params, device="cuda"), items,
                        "cuda", eps=k * 1e-6)
        res["perturbed"][f"{k}e-6"] = ate(state, gt, len(items))
    if args.perturb:
        a = list(res["perturbed"].values()) + [res["variants"]["base"][
            "ate"]] if "base" in res["variants"] else \
            list(res["perturbed"].values())
        res["perturbed_spread"] = [min(a), max(a)]
    if args.cpu_run:
        t0 = time.perf_counter()
        state = run_row(step_mod.VOFrontend(params, device="cpu"), items,
                        "cpu")
        res["cpu_run"] = {"ate": ate(state, gt, len(items)),
                          "seconds": time.perf_counter() - t0}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh)
    summary = {k: v for k, v in res.items() if k != "shadow"}
    if "shadow" in res:
        summary["shadow"] = {k: v for k, v in res["shadow"].items()
                             if k != "per_frame"}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
