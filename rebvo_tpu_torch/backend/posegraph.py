"""Pose graph: measurement log + optimizer (PyTorch counterpart of
rebvo_tpu/backend/posegraph.py; reference pose_graph,
include/mtracklib/pose_graph.h:31-131).

The reference keeps an append-only log of per-frame relative-pose
measurements and has no optimizer. This module keeps the log (the same
`.npz` format as the JAX package's) and its Gauss-Newton optimizer over
SE(3) node poses: per-edge Jacobians by reverse-mode autodiff
(`torch.func.jacrev` under `torch.func.vmap`: PyTorch's forward mode
gives a 0-d float32 tensor divided by a Python number a float64
tangent), a dense [6N, 6N] normal system, node 0 held by a strong
prior, `solve_ex` (no host sync). All
products are float32 with TF32 off, as the JAX package's `HIGHEST`
precision contractions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple

import numpy as np
import torch

from rebvo_tpu_torch.core.geometry import so3_exp

Tensor = torch.Tensor


@dataclass
class OdometryMeas:
    """One frame-to-frame measurement (pose_graph.h:31-85)."""

    rel_pose: np.ndarray          # [6] translation + rotation (Lie)
    W: np.ndarray                 # [6,6] information
    acel_s: np.ndarray = None
    acel_v: np.ndarray = None
    g_est: np.ndarray = None
    K: float = 1.0
    WK: float = 0.0
    QK: float = 0.0
    kf_id: int = -1


@dataclass
class PoseGraphLog:
    """Append-only measurement log (the reference's `poses`,
    rebvo.h:437)."""

    meas: List[OdometryMeas] = field(default_factory=list)

    def add_frame_meas(self, m: OdometryMeas) -> None:
        self.meas.append(m)

    def save(self, path: str) -> None:
        n = len(self.meas)
        z = dict(
            rel_pose=np.stack([m.rel_pose for m in self.meas]) if n else
            np.zeros((0, 6)),
            W=np.stack([m.W for m in self.meas]) if n else np.zeros((0, 6, 6)),
            K=np.asarray([m.K for m in self.meas]),
            WK=np.asarray([m.WK for m in self.meas]),
            QK=np.asarray([m.QK for m in self.meas]),
            kf_id=np.asarray([m.kf_id for m in self.meas], np.int64),
        )
        np.savez_compressed(path, **z)

    @staticmethod
    def load(path: str) -> "PoseGraphLog":
        z = np.load(path)
        log = PoseGraphLog()
        for i in range(z["rel_pose"].shape[0]):
            log.add_frame_meas(OdometryMeas(
                rel_pose=z["rel_pose"][i], W=z["W"][i], K=float(z["K"][i]),
                WK=float(z["WK"][i]), QK=float(z["QK"][i]),
                kf_id=int(z["kf_id"][i])))
        return log


class PoseGraphProblem(NamedTuple):
    """Fixed-size constraint set between N nodes. Edge e joins nodes
    (i, j) with the measured relative transform (R_ij, t_ij):
    R_j ~ R_i @ R_ij, p_j ~ p_i + R_i @ t_ij."""

    i: Tensor        # [E] int64
    j: Tensor        # [E] int64
    t_ij: Tensor     # [E, 3]
    w_ij: Tensor     # [E, 3] rotation measurement (Lie)
    info: Tensor     # [E] scalar weights or [E, 6, 6] information
                     # matrices (residual order [t(3); rot(3)])
    valid: Tensor    # [E] bool


def problem_from_log(log: PoseGraphLog, dtype=torch.float32, device="cuda"):
    """A chain PoseGraphProblem from a VOSystem pose log: node i+1 is node
    i composed with (exp(w_ij), t_ij), t_ij = rel_pose[:3] * K in frame
    i, weighted by the transported 6x6 information matrices (made
    symmetric). Returns (problem, n_nodes)."""
    n = len(log.meas)
    if n == 0:
        raise ValueError("empty pose log")
    t_ij = np.stack([m.rel_pose[:3] * m.K for m in log.meas])
    w_ij = np.stack([m.rel_pose[3:] for m in log.meas])
    info = np.stack([m.W for m in log.meas])
    info = 0.5 * (info + np.swapaxes(info, 1, 2))

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device=device,
                                                             dtype=dtype)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    prob = PoseGraphProblem(
        i=idx, j=idx + 1, t_ij=dev(t_ij), w_ij=dev(w_ij), info=dev(info),
        valid=torch.ones((n,), dtype=torch.bool, device=device))
    return prob, n + 1


def _so3_residual(R: Tensor) -> Tensor:
    """0.5 vee(R - R^T) = sin(theta) axis: the Lie log to first order,
    and differentiable at the identity."""
    return 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                              R[..., 0, 2] - R[..., 2, 0],
                              R[..., 1, 0] - R[..., 0, 1]], dim=-1)


def _edge_residual(Ri, pi, Rj, pj, t_ij, w_ij) -> Tensor:
    """6-vector residual of one edge (local frame)."""
    R_ij = so3_exp(w_ij)
    r_rot = _so3_residual((Ri @ R_ij).transpose(-1, -2) @ Rj)
    r_tr = (Ri.transpose(-1, -2) @ (pj - pi)[..., None])[..., 0] - t_ij
    return torch.cat([r_tr, r_rot], dim=-1)


def _edge_local(x, Ri, pi, Rj, pj, t_ij, w_ij):
    """The edge residual at a local update x = (dw_i, dp_i, dw_j, dp_j)
    (rotations left-multiplied)."""
    return _edge_residual(so3_exp(x[0:3]) @ Ri, pi + x[3:6],
                          so3_exp(x[6:9]) @ Rj, pj + x[9:12], t_ij, w_ij)


def optimize_pose_graph(R0: Tensor, p0: Tensor, prob: PoseGraphProblem,
                        iters: int = 10, damping: float = 1e-4):
    """Gauss-Newton over all node poses, node 0 gauge-fixed; `iters`
    iterations. Returns (R [N,3,3], p [N,3], costs [iters]): each cost is
    the weighted squared residual before that iteration's update."""
    from torch.func import jacrev, vmap
    N = R0.shape[0]
    dt, dev = p0.dtype, p0.device
    if prob.info.ndim == 1:
        Wm = torch.where(prob.valid, prob.info, torch.zeros_like(
            prob.info))[:, None, None] * torch.eye(6, dtype=dt, device=dev)
    else:
        Wm = torch.where(prob.valid[:, None, None], prob.info,
                         torch.zeros_like(prob.info))
    zeros12 = torch.zeros((prob.i.shape[0], 12), dtype=dt, device=dev)
    jac = vmap(jacrev(_edge_local))
    eye = torch.eye(6 * N, dtype=dt, device=dev) * damping
    eye[:6, :6] += torch.eye(6, dtype=dt, device=dev) * 1e8
    R, p, costs = R0, p0, []
    for _ in range(iters):
        args = (R[prob.i], p[prob.i], R[prob.j], p[prob.j], prob.t_ij,
                prob.w_ij)
        res = _edge_residual(*args)                          # [E, 6]
        Je = jac(zeros12, *args)                             # [E, 6, 12]
        Ji, Jj = Je[:, :, 0:6], Je[:, :, 6:12]
        JiW = Ji.transpose(1, 2) @ Wm                        # [E, 6, 6]
        JjW = Jj.transpose(1, 2) @ Wm
        H = torch.zeros((N, N, 6, 6), dtype=dt, device=dev)
        H.index_put_((prob.i, prob.i), JiW @ Ji, accumulate=True)
        H.index_put_((prob.j, prob.j), JjW @ Jj, accumulate=True)
        Hij = JiW @ Jj
        H.index_put_((prob.i, prob.j), Hij, accumulate=True)
        H.index_put_((prob.j, prob.i), Hij.transpose(1, 2), accumulate=True)
        b = torch.zeros((N, 6), dtype=dt, device=dev)
        b.index_add_(0, prob.i, (JiW @ res[..., None])[..., 0])
        b.index_add_(0, prob.j, (JjW @ res[..., None])[..., 0])
        Hd = H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N) + eye
        dx = torch.linalg.solve_ex(Hd, -b.reshape(6 * N, 1))[0].reshape(N, 6)
        costs.append(torch.sum((res[:, None, :] @ Wm @ res[..., None])))
        R = so3_exp(dx[:, 0:3]) @ R
        p = p + dx[:, 3:6]
    return R, p, torch.stack(costs)
