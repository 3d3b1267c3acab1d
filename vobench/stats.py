"""The benchmark's arithmetic on timings: rates over a window, tails
over all samples, and the spread of repeated runs."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) of all values, linear between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Work per second over a window of `seconds`."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, as `statistics.quantiles(values, n=4)` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
