"""Per-stage ops of the step and the hand-written CUDA kernels."""
