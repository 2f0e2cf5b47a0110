"""One reader per per-layer metric, named as the metric: ``read(records)``
returns the metric's value from a traced run's records, or None where the
run has nothing for it to read."""
