"""The benchmark of the PyTorch and CUDA port (rebvo_tpu_torch): a
data-driven harness. BENCHMARK.json at the repository root names the
cells; each cell's configuration, traffic, correctness limits and
per-layer metrics are files under vobench/ found by name.

    python -m vobench.run --workload NAME --seed N --seconds S --trace 0|1
"""
