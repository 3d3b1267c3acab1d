"""The arithmetic of the per-layer metrics that read the program's own
records (vobench.runners._obs: host spans with `start_ns`, `end_ns` and
`profiled`, device stage times with `device_ms` and `lanes`), and of
the traced gaps under the program's spans. Each returns None where
there is nothing to read."""

from __future__ import annotations

import statistics
from typing import Iterable, Optional

from vobench.runners import _obs


def _median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None


def _host_ms(rec: dict) -> float:
    return (rec["end_ns"] - rec["start_ns"]) * 1e-6


def stage_ms_per_lane_frame(name: str) -> Optional[float]:
    """Median over the run's steps of device stage `name`'s time over
    the step's lanes (ms)."""
    return _median(r["device_ms"] / r["lanes"] for r in _obs.records()
                   if r["name"] == name and r["device_ms"] is not None)


def span_ms(name: str) -> Optional[float]:
    """Median host time of span `name` over its records outside a
    profiler session (ms)."""
    return _median(_host_ms(r) for r in _obs.records()
                   if r["name"] == name and r["device_ms"] is None
                   and not r["profiled"])


def unit_span_ms(names: Iterable[str]) -> Optional[float]:
    """Median over the units holding each of the spans `names`, none of
    them inside a profiler session, of their summed host time (ms)."""
    names = set(names)
    per: dict = {}
    for r in _obs.records():
        if r["name"] in names and r["device_ms"] is None:
            per.setdefault(r["unit"], []).append(r)
    return _median(sum(_host_ms(r) for r in rs) for rs in per.values()
                   if {r["name"] for r in rs} == names
                   and not any(r["profiled"] for r in rs))


def gap_ms_per_unit(r, prefix: str) -> Optional[float]:
    """Traced idle time labelled by the program's spans named `prefix`*
    a traced unit (ms); None where the trace has no such span."""
    t = r.trace
    if t is None or not r.traced_units or \
            not any(k.startswith(prefix) for k in t.spans):
        return None
    return sum(v for k, v in t.gaps.items()
               if k.startswith(prefix)) / r.traced_units * 1e3
