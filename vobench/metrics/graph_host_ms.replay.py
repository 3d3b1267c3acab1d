"""The host side of a graph call: the median over the calls outside the
profiler of the program's spans `graph.copy_in` (inputs into the graph's
static buffers), `graph.replay` (the launch) and `graph.clone_out` (the
outputs' clones), summed a call (ms)."""

from vobench.metrics._spans import unit_span_ms


def read(r):
    return unit_span_ms(("graph.copy_in", "graph.replay", "graph.clone_out"))
