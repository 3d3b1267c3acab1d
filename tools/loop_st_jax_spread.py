"""The spread of the JAX package's own `loop_st` parity row under starts
a few float32 ulps apart (CPU only; no card).

    python3 tools/loop_st_jax_spread.py [--perturb 8] [--frames 240]
        [--seq-dir DIR] [--out build/loop_st_jax/spread.json]

Renders the `loop_st` row (the port's `apps/parity.render_dataset`, whose
pixels equal the JAX harness's, tests/test_torch_parity.py) under
build/loop_st_jax/ unless `--seq-dir` names one already rendered, then
runs `rebvo_tpu`'s front end over it on the CPU as `rebvo_tpu.apps.run_vo
--config <parity config> --cpu` does (bootstrap, then `step_donated` per
frame with the cam1 pair), once unperturbed and once for each k =
1..--perturb with the stereo scale integrator VScaleC set to 1 + k * 1e-6
after the bootstrap: the same starts `tools/loop_st_probe.py --perturb`
gives the port on the card. The perturbation is set from outside the
package (`state._replace`); nothing in `rebvo_tpu/` changes. Each run's
ATE is apps/parity's: the logged positions resampled to the row's
frames, the first 40 dropped, similarity-aligned to the ground truth.

Prints one JSON line per run as it ends and writes the whole result to
`--out` after every run, so a cut run keeps what it reached.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BAR = 0.0229          # the row's parity bar on the card (PERF.md section 5)


def render(seq_dir: str, n: int) -> float:
    """Render the row once (the port's 8-thread renderer); seconds."""
    if os.path.exists(os.path.join(seq_dir, "gt_pos.txt")):
        return 0.0
    from rebvo_tpu_torch.apps import parity as tparity
    os.makedirs(seq_dir, exist_ok=True)
    t0 = time.perf_counter()
    tparity.render_dataset(seq_dir, "loop_st", n,
                           tparity.seq_seed("loop_st"))
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--perturb", type=int, default=8)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--seq-dir", default=os.path.join(
        ROOT, "build", "loop_st_jax", "loop_st"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "loop_st_jax", "spread.json"))
    args = ap.parse_args(argv)

    render_s = render(args.seq_dir, args.frames)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from rebvo_tpu.apps import parity as jparity
    from rebvo_tpu.frontend.step import VOFrontend
    from rebvo_tpu.io.dataset import DatasetSequence
    from rebvo_tpu.io.logger import RunLogger
    from rebvo_tpu.io.trajectory import ate_rmse

    n = args.frames
    params = jparity.parity_params(args.seq_dir, st=True)
    params = params.replace(NavLogCap=max(params.NavLogCap, n + 8))
    items = [(t, np.asarray(f, np.float32), pr) for t, f, _, pr in
             list(DatasetSequence.from_params(params))[:n]]
    gt = np.loadtxt(os.path.join(args.seq_dir, "gt_pos.txt"))
    fe = VOFrontend(params)
    warm = min(40, n // 4)

    def run(eps: float) -> float:
        t, f, pr = items[0]
        pair = None if pr is None else jnp.asarray(pr)
        state = fe.bootstrap(fe.init(), jnp.asarray(f), jnp.asarray(t), pair)
        state = state._replace(VScaleC=state.VScaleC * (1.0 + eps))
        for t, f, pr in items[1:]:
            pair = None if pr is None else jnp.asarray(pr)
            state, _ = fe.step_donated(state, jnp.asarray(f),
                                       jnp.asarray(t), pair)
        rows = RunLogger.from_device_log(state.navlog, state.navlog_n).rows
        pos = np.stack([r["Pos"] for r in rows])
        return float(ate_rmse(jparity._resample(pos, n)[warm:], gt[warm:],
                              with_scale=True))

    res = {"package": "rebvo_tpu", "device": "cpu", "seq": "loop_st",
           "frames": len(items), "render_s": render_s, "bar_m": BAR,
           "runs": {}}
    for k in range(args.perturb + 1):
        t0 = time.perf_counter()
        a = run(k * 1e-6)
        res["runs"][f"{k}e-6"] = {"ate": a,
                                  "seconds": time.perf_counter() - t0}
        print(json.dumps({f"{k}e-6": res["runs"][f"{k}e-6"]}), flush=True)
        ates = [r["ate"] for r in res["runs"].values()]
        res.update(spread=[min(ates), max(ates)],
                   above_bar=sum(x > BAR for x in ates))
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh)
    print(json.dumps({k: v for k, v in res.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
