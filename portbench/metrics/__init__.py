"""One reader a metric: ``read(rec)`` takes a run's record (portbench/run.py
``run_cell``, with ``trace`` and ``roofline`` in a traced run) and returns
the metric's value, or None where the run has nothing to read."""
