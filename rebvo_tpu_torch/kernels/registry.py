"""Every hand-written kernel's wrapper: K1 and K2 of
kernels/cuda_scale_space, K3's kernels/pose_solver.minimizer_rv and, its
3-dof mode, minimizer_v, K4's frontend/kf_tracking.correct_and_augment,
and K5's kernels/match_depth.md_match and md_depth.
Each counts its launches in `.launches`; `graphs.capture_graph`,
`apps/run_vo` and `chip_smoke.py` read them all from `WRAPPERS`."""

from rebvo_tpu_torch.frontend.kf_tracking import correct_and_augment
from rebvo_tpu_torch.kernels.cuda_scale_space import (build_scale_space_cuda,
                                                      detect_candidates_cuda)
from rebvo_tpu_torch.kernels.match_depth import md_depth, md_match
from rebvo_tpu_torch.kernels.pose_solver import minimizer_rv, minimizer_v

WRAPPERS = (detect_candidates_cuda, build_scale_space_cuda, minimizer_rv,
            minimizer_v, correct_and_augment, md_match, md_depth)
