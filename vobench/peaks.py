"""Published peaks of the card and the work counts that rooflines are
read against. Frozen with the benchmark: a kernel that later replaces
K1 is read against the same count of bytes."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the full 700 W limit.
H100_HBM_BYTES_PER_S = 3.35e12

# K1 (frame -> detector candidates) per pixel: the float32 frame read
# once, the uint8 mask and five float32 maps (theta_x, theta_y, xs, ys,
# n2_m) written once.
K1_BYTES_PER_PIXEL = 4 + 1 + 5 * 4


def k1_bytes(frames: int, height: int, width: int) -> int:
    """Bytes K1 must move for `frames` frames of height x width."""
    return frames * height * width * K1_BYTES_PER_PIXEL


def k1_bound_s(frames: int, height: int, width: int) -> float:
    """The least time the card could take for K1's work: its bytes over
    the card's memory bandwidth (the work is bound by bytes)."""
    return k1_bytes(frames, height, width) / H100_HBM_BYTES_PER_S
