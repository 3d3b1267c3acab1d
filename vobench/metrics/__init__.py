"""Per-layer metric readers, one file per metric of BENCHMARK.json's
`per_layer`, each with `read(reading)` returning the value or None when
its run has nothing to read (vobench.run.Reading)."""
