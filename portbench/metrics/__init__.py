"""One reader a metric: ``read(rec)`` takes a run's record (portbench/run.py
``run_cell``, with ``trace`` in a traced run) and returns the metric's value,
or None where the run has nothing to read. A reader that reads a kernel's
roofline names the kernel, ``ROOFLINE = "<kernel>"``; the run then counts
``portbench/roofline/<kernel>.py``'s work into ``rec["rooflines"][kernel]``.
A kernel's device time is in ``rec["trace"]["by_kernel"]``."""
