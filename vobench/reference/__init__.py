"""The benchmark's plain reference: a frozen copy of the port's plain
VO step (mono and visual-inertial), its detector's plain form, the
undistortion and the configuration schema. It imports nothing of the
measured program and nothing of JAX; the benchmark's checks run it on
the same inputs as the program and compare the two.
"""

import torch

# TF32 keeps about three decimal digits: off, as in the measured program.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
