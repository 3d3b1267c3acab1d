"""rebvo_tpu_torch: the PyTorch / CUDA port of rebvo_tpu.

Mirrors `rebvo_tpu`'s module layout and public names so each counterpart
sits at the same path. It imports neither JAX nor `rebvo_tpu`: the few
modules it shares in spirit (config, io.trajectory, io.render) are its
own copies. Entry points run on the CUDA device unless the caller asks
for the CPU (`device="cpu"`, `run_vo --cpu`).
"""

import torch

# The JAX reference contracts the pose-solver normal equations at
# Precision.HIGHEST (kernels/pose_solver.py). TF32 keeps ~3 decimal digits,
# enough to flip the LM accept test and the solver's rung choice, so both
# matmul and cuDNN TF32 stay off for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from rebvo_tpu_torch.config import REBVOParameters, load_config  # noqa: E402

__all__ = ["REBVOParameters", "load_config"]
