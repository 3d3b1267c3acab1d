"""Trajectory output and evaluation.

The reference writes a TUM-format trajectory file (`t x y z qx qy qz qw`,
reference src/rebvo/rebvo_third_t.cpp:311) as its accuracy oracle and
leaves ATE evaluation to external scripts; here both the writer and the
ATE/RPE computation live in-repo (SURVEY.md §4 'build what the reference
lacks').
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def write_tum(path: str, ts: Sequence[float], pos: np.ndarray,
              quat: np.ndarray) -> None:
    """Write a TUM trajectory file: `t x y z qx qy qz qw` per line."""
    pos = np.asarray(pos)
    quat = np.asarray(quat)
    with open(path, "w") as fh:
        for i, t in enumerate(ts):
            x, y, z = pos[i]
            qx, qy, qz, qw = quat[i]
            fh.write(f"{t:.9f} {x:.9f} {y:.9f} {z:.9f} "
                     f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}\n")


def read_tum(path: str):
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Similarity alignment est -> gt (Umeyama closed form).

    Returns (scale, R, t) minimising || gt - (s R est + t) ||^2 — the
    standard monocular-VO evaluation alignment.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum() / est.shape[0]
        s = np.trace(np.diag(D) @ S) / var_e if var_e > 0 else 1.0
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE) after similarity alignment."""
    s, R, t = align_umeyama(est, gt, with_scale)
    aligned = (s * (R @ np.asarray(est, np.float64).T)).T + t
    err = aligned - np.asarray(gt, np.float64)
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe_rmse(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> float:
    """Relative pose error (translation RMSE over `delta`-frame windows)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    # per-window scale-free comparison is out of scope; plain difference
    err = de - dg
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
