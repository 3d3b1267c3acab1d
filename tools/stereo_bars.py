"""The stereo path's scale against the written path, in working order and
with five faults, on phase 10/11's fixture of `chip_smoke.py`: the
readings against which `chip_smoke.py` sets phase 11's bars.

    python3 tools/stereo_bars.py

Writes the 62-frame `io/render.write_euroc_vi(stereo=True)` directory at
the default configuration (seed 0, as `chip_smoke.write_fixture`) under
chiprun_out/stereo_bars/, then runs the default configuration with
StereoAvaiable=1 through both cameras' undistortion and `step_donated`
six ways:

  stereo          the pair on every frame (what phase 11 runs);
  no_vel_rescale  StereoVelRescale=0: the solver's translation magnitude
                  is kept, not the pair-anchored scale carry;
  pair_dropped    the pair at the bootstrap frame only, then none (a
                  dropped cam1 stream: the step runs mono on the
                  bootstrap's gauge);
  half_baseline   the extrinsics' translation halved against the one the
                  fixture was rendered with: every stereo depth half the
                  true one, as a fault in the pair's geometry gives;
  double_baseline the translation doubled: every depth twice the true one;
  pair_lag        cam1's frame three frames late (a pair out of sync).

For each it prints one JSON line: over the moving frames, against the
written path with no scale fitted by the system, the similarity
alignment's scale and the rigidly and similarity-aligned ATE as shares of
the path's extent, and the stereo matches' share of `klm_num` on frames
2-9 and from frame 10. Needs the card; imports no JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rebvo_tpu_torch.config import REBVOParameters  # noqa: E402
from rebvo_tpu_torch.frontend.step import VOFrontend  # noqa: E402
from rebvo_tpu_torch.io.dataset import DatasetSequence  # noqa: E402
from rebvo_tpu_torch.io.render import write_euroc_vi  # noqa: E402
from rebvo_tpu_torch.io.trajectory import (align_umeyama,  # noqa: E402
                                           ate_rmse)
from rebvo_tpu_torch.io.undistort import (apply_undistort,  # noqa: E402
                                          build_undistort_map)

_P = REBVOParameters()
# name: (parameter overrides, cam1 frame index for frame i; None: no pair)
VARIANTS = {
    "stereo": ({}, lambda i, n: i),
    "no_vel_rescale": ({"StereoVelRescale": 0}, lambda i, n: i),
    "pair_dropped": ({}, lambda i, n: None),
    "half_baseline": ({f"StereoT{c}": getattr(_P, f"StereoT{c}") / 2
                       for c in "xyz"}, lambda i, n: i),
    "double_baseline": ({f"StereoT{c}": getattr(_P, f"StereoT{c}") * 2
                         for c in "xyz"}, lambda i, n: i),
    "pair_lag": ({}, lambda i, n: min(i + 3, n - 1))}
FRAMES = 60      # phase 11's stereo frames
SETTLED = 10     # the frame from which the stereo share has settled
OUT = os.path.join("chiprun_out", "stereo_bars")


def run(p, f0, f1, ts, pair_of):
    """Positions, stereo_num and klm_num of frames 1.. (step_donated);
    the bootstrap frame always has its own pair."""
    fe = VOFrontend(p, device="cuda")
    um0 = build_undistort_map(fe.cam, device="cuda")
    um1 = build_undistort_map(fe.cam_pair, device="cuda")
    state = fe.bootstrap(fe.init(), apply_undistort(um0, f0[0]), ts[0],
                         apply_undistort(um1, f1[0]))
    outs = []
    for i in range(1, len(ts)):
        j = pair_of(i, len(ts))
        pair = None if j is None else apply_undistort(um1, f1[j])
        state, out = fe.step_donated(state, apply_undistort(um0, f0[i]),
                                     ts[i], pair)
        outs.append(out)
    pos = np.stack([o.nav.Pos.cpu().numpy() for o in outs])
    snum = np.asarray([int(o.stereo_num) for o in outs])
    klm = np.asarray([int(o.nav.klm_num) for o in outs])
    return pos, snum, klm, float(state.VScaleC)


def main() -> int:
    if not torch.cuda.is_available():
        print("stereo_bars: needs a CUDA card", file=sys.stderr)
        return 2
    d = os.path.join(OUT, "euroc_vi")
    shutil.rmtree(d, ignore_errors=True)
    _, pos_true = write_euroc_vi(REBVOParameters(), 62, d, workers=8,
                                 stereo=True)
    items = list(DatasetSequence.euroc(d, with_imu=False,
                                       stereo=True))[:FRAMES]
    ts = [t for t, _, _, _ in items]
    f0 = [torch.as_tensor(f, device="cuda") for _, f, _, _ in items]
    f1 = [torch.as_tensor(g, device="cuda") for _, _, _, g in items]
    for name, (over, pair_of) in VARIANTS.items():
        p = REBVOParameters().replace(StereoAvaiable=1, **over)
        move = p.InitBiasFrameNum + 2     # the path's first moving frame
        pos, snum, klm, vscale = run(p, f0, f1, ts, pair_of)
        # pos[i - 1] is frame i
        est_on, true_on = pos[move:], pos_true[move + 1:FRAMES]
        extent = float(np.ptp(true_on, axis=0).max())
        finite = bool(np.all(np.isfinite(pos)))
        share = snum / np.maximum(klm, 1)
        line = {"variant": name, "overrides": over,
                "frames": FRAMES, "pos_finite": finite,
                "path_extent": extent, "VScaleC_final": vscale,
                "stereo_num_min_after_first": int(snum[1:].min()),
                "stereo_share_min_frames_2_9":
                    float(share[1:SETTLED - 1].min()),
                "stereo_share_min_settled": float(share[SETTLED - 1:].min())}
        if finite:
            line.update(
                scale_vs_path=float(align_umeyama(est_on, true_on)[0]),
                ate_rigid_share=ate_rmse(est_on, true_on,
                                         with_scale=False) / extent,
                ate_similarity_share=ate_rmse(est_on, true_on) / extent)
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
