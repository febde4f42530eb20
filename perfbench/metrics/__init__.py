"""Readers of the metrics, one file a metric, found by its name in
BENCHMARK.json: each has ``read(run)``, which returns the number or None
where it finds nothing to read."""
