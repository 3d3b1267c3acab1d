"""Every hand-written kernel's wrapper: K1 and K2 of
kernels/cuda_scale_space, K3's kernels/pose_solver.minimizer_rv and, its
3-dof mode, minimizer_v. Each
counts its launches in `.launches`; `graphs.capture_graph`,
`apps/run_vo` and `chip_smoke.py` read them all from `WRAPPERS`."""

from rebvo_tpu_torch.kernels.cuda_scale_space import (build_scale_space_cuda,
                                                      detect_candidates_cuda)
from rebvo_tpu_torch.kernels.pose_solver import minimizer_rv, minimizer_v

WRAPPERS = (detect_candidates_cuda, build_scale_space_cuda, minimizer_rv,
            minimizer_v)
