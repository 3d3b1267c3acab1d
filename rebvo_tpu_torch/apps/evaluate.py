"""CLI: evaluate a TUM-format trajectory against ground truth, ATE and
RPE (PyTorch port of rebvo_tpu/apps/evaluate.py; the reference leaves
this to external scripts, README.md:249-251). Ground truth is a TUM file
or a EuRoC state_groundtruth CSV. Host-side numpy only.

    python -m rebvo_tpu_torch.apps.evaluate est.txt gt.txt
    python -m rebvo_tpu_torch.apps.evaluate est.txt \\
        /data/MH_01/mav0/state_groundtruth_estimate0/data.csv --euroc-gt
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from rebvo_tpu_torch.io.trajectory import ate_rmse, read_tum, rpe_rmse


def read_euroc_gt(path: str, time_scale: float = 1e-9):
    """(t [n] in s, positions [n, 3]) of a EuRoC ground-truth CSV."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split(",")
            rows.append([float(p[0]) * time_scale,
                         float(p[1]), float(p[2]), float(p[3])])
    arr = np.asarray(rows)
    return arr[:, 0], arr[:, 1:4]


def associate(t_est, t_gt, max_dt=0.02):
    """Nearest-timestamp association (the TUM tool's rule): (ok [n_est],
    index into t_gt [n_est])."""
    idx = np.searchsorted(t_gt, t_est)
    idx = np.clip(idx, 1, len(t_gt) - 1)
    left = idx - 1
    use_left = np.abs(t_gt[left] - t_est) < np.abs(t_gt[idx] - t_est)
    best = np.where(use_left, left, idx)
    ok = np.abs(t_gt[best] - t_est) <= max_dt
    return ok, best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("est")
    ap.add_argument("gt")
    ap.add_argument("--euroc-gt", action="store_true")
    ap.add_argument("--no-scale", action="store_true",
                    help="align without scale (stereo/VIO)")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)

    t_est, p_est, _ = read_tum(args.est)
    if args.euroc_gt:
        t_gt, p_gt = read_euroc_gt(args.gt)
    else:
        t_gt, p_gt, _ = read_tum(args.gt)

    ok, best = associate(t_est, t_gt, args.max_dt)
    if ok.sum() < 3:
        raise SystemExit("too few associated poses")
    est = p_est[ok]
    gt = p_gt[best[ok]]

    result = {
        "pairs": int(ok.sum()),
        "ate_rmse_m": ate_rmse(est, gt, with_scale=not args.no_scale),
        "rpe_rmse_m": rpe_rmse(est, gt),
        "length_m": float(np.linalg.norm(np.diff(gt, axis=0),
                                         axis=1).sum()),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
