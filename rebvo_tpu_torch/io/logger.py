"""Per-frame state logging (PyTorch counterpart of rebvo_tpu/io/logger.py;
reference src/rebvo/rebvo_third_t.cpp:259-313): the TUM trajectory and
the Matlab-format `.m` log, built from the step's device nav-log ring in
one transfer at the end of a run (`from_device_log`), or from the frame
outputs pushed one by one (`push`, VOSystem's path), which are copied to
the host only when the rows are first read.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np
import torch

from rebvo_tpu_torch.io.trajectory import write_tum


class RunLogger:
    """Holds per-frame nav rows (the RunLogger row-dict schema)."""

    def __init__(self):
        self._pending: List = []    # (FrameOutput, tproc) not yet on host
        self._rows: List[dict] = []

    def push(self, out, tproc=(0.0, 0.0, 0.0)) -> None:
        """Record one FrameOutput without a host sync; `tproc` holds the
        host-side stage times (the reference's dtp0/dtp1/TProc2,
        rebvo_third_t.cpp:303-305)."""
        self._pending.append((out, tproc))

    def _drain(self) -> None:
        from rebvo_tpu_torch.frontend.step import pack_nav_row, \
            unpack_nav_rows
        if not self._pending:
            return
        host = torch.stack([pack_nav_row(o) for o, _ in self._pending])
        rows = unpack_nav_rows(host.detach().cpu().numpy())
        for r, (out, tp) in zip(rows, self._pending):
            r["Pose"] = out.nav.Pose.detach().cpu().numpy()
            r["Rot"] = out.nav.Rot.detach().cpu().numpy()
            r["tproc"] = tuple(tp)
        self._pending = []
        self._rows.extend(rows)

    @property
    def rows(self) -> List[dict]:
        self._drain()
        return self._rows

    @staticmethod
    def from_device_log(navlog: torch.Tensor, navlog_n) -> "RunLogger":
        """Build a logger from a VOState's nav-log ring
        (frontend/step.py NAVLOG_*) with one device-to-host transfer."""
        from rebvo_tpu_torch.core.geometry import so3_exp
        from rebvo_tpu_torch.frontend.step import unpack_nav_rows
        n = int(navlog_n)
        cap = navlog.shape[0]
        host = navlog.detach().cpu().numpy()
        if n <= cap:
            host = host[:n]
        else:                                    # ring wrapped: oldest first
            k = n % cap
            host = np.concatenate([host[k:], host[:k]])
        lg = RunLogger()
        lg._rows = unpack_nav_rows(host)
        if lg._rows:
            PL = torch.as_tensor(np.stack([r["PoseLie"] for r in lg._rows]))
            RL = torch.as_tensor(np.stack([r["RotLie"] for r in lg._rows]))
            for r, P, R in zip(lg._rows, so3_exp(PL).numpy(),
                               so3_exp(RL).numpy()):
                r["Pose"] = P
                r["Rot"] = R
                r["tproc"] = (0.0, 0.0, 0.0)
        return lg

    def __len__(self) -> int:
        return len(self._pending) + len(self._rows)

    # -- TUM trajectory (rebvo_third_t.cpp:311) --

    def write_trajectory(self, path: str) -> None:
        from rebvo_tpu_torch.core.geometry import rotation_to_quaternion
        rows = self.rows
        ts = [r["t"] for r in rows]
        pos = np.stack([r["Pos"] for r in rows])
        poses = torch.as_tensor(np.stack([r["Pose"] for r in rows]))
        quat = rotation_to_quaternion(poses).numpy()
        write_tum(path, ts, pos, quat)

    # -- Matlab-format state log (rebvo_third_t.cpp:265-305) --

    def write_mfile(self, path: str) -> None:
        def mat(name, rows):
            arr = np.asarray(rows)
            if arr.ndim == 1:
                arr = arr[:, None]
            lines = ";\n".join(
                " ".join(f"{v:.9g}" for v in np.atleast_1d(row))
                for row in arr)
            return f"{name}=[{lines}];\n"

        rows = self.rows
        with open(path, "w") as fh:
            fh.write(mat("t", [r["t"] for r in rows]))
            fh.write(mat("dt", [r["dt"] for r in rows]))
            fh.write(mat("RotLie", [r["RotLie"] for r in rows]))
            fh.write(mat("Vel", [r["Vel"] for r in rows]))
            fh.write(mat("PoseLie", [r["PoseLie"] for r in rows]))
            fh.write(mat("Pos", [r["Pos"] for r in rows]))
            fh.write(mat("Gest", [r["g"] for r in rows]))
            fh.write(mat("Kscale", [r["scale"] for r in rows]))
            fh.write(mat("EstimationOK", [int(r["ok"]) for r in rows]))
            fh.write(mat("KLnum", [r["kl_num"] for r in rows]))
            fh.write(mat("KLMnum", [r["klm_num"] for r in rows]))
            fh.write(mat("SrhoQ", [r["s_rho_q"] for r in rows]))
            fh.write(mat("Score", [r["score"] for r in rows]))
            fh.write(mat("StereoNum", [r["stereo_num"] for r in rows]))
            fh.write(mat("KFId", [r.get("kf_id", -1) for r in rows]))
            fh.write(mat("KFBackM", [r.get("kf_back_m", 0) for r in rows]))
            fh.write(mat("KFSaved", [int(r.get("kf_saved", 0))
                                     for r in rows]))
            self._write_reference_census(fh, rows)

    def _write_reference_census(self, fh, rows) -> None:
        """The reference's per-frame `*_cv` assignment statements
        (rebvo_third_t.cpp:259-305); IMU arrays are zeros in mono."""
        def v3(x):
            return f"[{x[0]:.9g},{x[1]:.9g},{x[2]:.9g}]"

        def m33(M):
            return ("[" + ";".join(
                ",".join(f"{M[a, b]:.9g}" for b in range(3))
                for a in range(3)) + "]")

        dbg_row = {"giro": 0, "acel": 1, "cacel": 2, "dgiro": 3,
                   "GBias": 4, "dWv": 5, "dWgv": 6, "VBias": 7,
                   "Av": 8, "As": 9, "Posgv": 10}
        for i, r in enumerate(rows, start=1):
            d = r.get("imu_dbg", np.zeros((11, 3)))
            tp = r.get("tproc", (0.0, 0.0, 0.0))
            fh.write(f"Kp_cv({i},:)={r.get('Kp', 1.0):.9g};\n")
            fh.write(f"RKp_cv({i},:)={r.get('RKp', 0.0):.9g};\n")
            fh.write(f"Rot_cv({i},:,:)={m33(r['Rot'])};\n")
            fh.write(f"Vel_cv({i},:)={v3(r['Vel'])};\n")
            fh.write(f"RotGiro_cv({i},:)={v3(d[dbg_row['giro']])};\n")
            fh.write(f"t_cv({i},:)={r['t']:.9g};\n")
            fh.write(f"dt_cv({i},:)={r['dt']:.9g};\n")
            fh.write(f"i_cv({i},:)={i};\n")
            fh.write(f"Pose_cv({i},:,:)={m33(r['Pose'])};\n")
            fh.write(f"Pos_cv({i},:)={v3(r['Pos'])};\n")
            fh.write(f"K_cv({i},:)={r['scale']:.9g};\n")
            fh.write(f"KLN_cv({i},:)={r['kl_num']};\n")
            fh.write(f"Giro_cv({i},:)={v3(d[dbg_row['giro']])};\n")
            fh.write(f"Acel_cv({i},:)={v3(d[dbg_row['acel']])};\n")
            fh.write(f"CAcel_cv({i},:)={v3(d[dbg_row['cacel']])};\n")
            fh.write(f"DGiro_cv({i},:)={v3(d[dbg_row['dgiro']])};\n")
            fh.write(f"GBias_cv({i},:)={v3(d[dbg_row['GBias']])};\n")
            fh.write(f"dWv_cv({i},:)={v3(d[dbg_row['dWv']])};\n")
            fh.write(f"dWgv_cv({i},:)={v3(d[dbg_row['dWgv']])};\n")
            fh.write(f"g_cv({i},:)={v3(r['g'])};\n")
            fh.write(f"VBias_cv({i},:)={v3(d[dbg_row['VBias']])};\n")
            fh.write(f"Av_cv({i},:)={v3(d[dbg_row['Av']])};\n")
            fh.write(f"As_cv({i},:)={v3(d[dbg_row['As']])};\n")
            fh.write(f"Posgv_cv({i},:)={v3(d[dbg_row['Posgv']])};\n")
            fh.write(f"SMM_cv({i},:)={r['stereo_num']};\n")
            fh.write(f"TProc0_cv({i},:)={tp[0]:.9g};\n")
            fh.write(f"TProc1_cv({i},:)={tp[1]:.9g};\n")
            fh.write(f"TProc2_cv({i},:)={tp[2]:.9g};\n")


def read_mfile(path: str) -> dict:
    """Parse a rebvo_log.m from either system into {name: ndarray}."""
    with open(path) as fh:
        txt = fh.read()
    out: dict = {}
    rows: dict = {}
    for m in re.finditer(
            r"(?m)^\s*(\w+)\((\d+)(?:,:)*\)\s*=\s*(\[[^\]]*\]|[^;]+);",
            txt):
        name, idx, rhs = m.group(1), int(m.group(2)), m.group(3)
        vals = [float(x) for x in
                re.split(r"[,\s;]+", rhs.strip().strip("[]")) if x]
        rows.setdefault(name, {})[idx] = vals
    for name, d in rows.items():
        n = max(d)
        width = max(len(v) for v in d.values())
        arr = np.zeros((n, width))
        for i, v in d.items():
            arr[i - 1, :len(v)] = v
        out[name] = arr
    for m in re.finditer(r"(?ms)^(\w+)=\[(.*?)\];", txt):
        name, body = m.group(1), m.group(2)
        mat = [[float(x) for x in re.split(r"[\s,]+", r.strip()) if x]
               for r in body.split(";") if r.strip()]
        out[name] = np.asarray(mat)
    return out
