"""Device idle time under the program's graph spans (`graph.copy_in`,
`graph.replay`, `graph.clone_out`) a traced unit: the gaps of the trace
labelled by those spans (ms). Traced, so stretched by the profiler:
compare it between traced runs only."""

from vobench.metrics._spans import gap_ms_per_unit


def read(r):
    return gap_ms_per_unit(r, "graph.")
