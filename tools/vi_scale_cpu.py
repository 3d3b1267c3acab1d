"""The full-width visual-inertial scale on `chip_smoke.py`'s phase-10
fixture, from either package's run_vo on the CPU.

    python3 tools/vi_scale_cpu.py --package rebvo_tpu
    python3 tools/vi_scale_cpu.py --package rebvo_tpu_torch

Writes the 62-frame `io/render.write_euroc_vi` directory at the default
configuration (seed 0, as `chip_smoke.write_fixture`) under
build/vi_scale/, runs `python -m <package>.apps.run_vo --cpu --euroc DIR
--imu --max-frames 60` on it in a subprocess (752x480, KeylineMax=16384),
and prints one JSON line: the scale filter's K on the last frame and its
range over the filtered frames, and, over the filtered frames as phase 10
takes them, the similarity alignment's scale against the written path
and the similarity- and rigidly aligned ATE. This process imports only
the port; the package named runs in its own interpreter.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rebvo_tpu_torch.config import REBVOParameters  # noqa: E402
from rebvo_tpu_torch.io.logger import read_mfile  # noqa: E402
from rebvo_tpu_torch.io.render import write_euroc_vi  # noqa: E402
from rebvo_tpu_torch.io.trajectory import align_umeyama, ate_rmse  # noqa

N_VI = 60           # the frames phase 10 steps (of the 62 written)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--package", default="rebvo_tpu_torch",
                    choices=("rebvo_tpu", "rebvo_tpu_torch"))
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build",
                                                      "vi_scale"))
    args = ap.parse_args(argv)

    p = REBVOParameters()
    on = 5 + p.InitBiasFrameNum          # the scale filter's first step
    fixture = os.path.join(args.out_dir, "euroc_vi")
    shutil.rmtree(fixture, ignore_errors=True)
    _, pos_true = write_euroc_vi(p, N_VI + 2, fixture, workers=8)
    run_dir = os.path.join(args.out_dir, args.package)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               REBVO_COMPILE_CACHE=os.path.join(args.out_dir, "jax_cache"))
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", f"{args.package}.apps.run_vo",
                    "--cpu", "--euroc", fixture, "--imu", "--max-frames",
                    str(N_VI), "--out-dir", run_dir], cwd=ROOT, env=env,
                   check=True, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    pos = np.loadtxt(os.path.join(run_dir, p.TrayFile))[:, 1:4]
    K = np.asarray(read_mfile(os.path.join(run_dir, p.LogFile))["K_cv"],
                   np.float64).ravel()
    # row i is frame i + 1: the frames from the filter's start
    est_on, true_on = pos[on - 1:], pos_true[on:N_VI]
    print(json.dumps({
        "package": args.package, "device": "cpu", "frames": N_VI,
        "K_final": float(K[-1]), "K_min_filtered": float(K[on - 1:].min()),
        "K_max_filtered": float(K[on - 1:].max()),
        "scale_vs_path": float(align_umeyama(est_on, true_on)[0]),
        "ate_vs_path": float(ate_rmse(est_on, true_on)),
        "ate_vs_path_metric": float(ate_rmse(est_on, true_on,
                                             with_scale=False)),
        "path_extent": float(np.ptp(true_on, axis=0).max()),
        "run_vo_wall_s": wall}))


if __name__ == "__main__":
    main()
