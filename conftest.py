"""The test harness's process-wide rules, for every pytest process: the
controller that starts the xdist workers, each worker, and a plain run.

- The JAX package's native library is built once, before any worker starts,
  so that each worker's `native_available()` finds an up-to-date library
  while it collects tests and builds nothing itself.
- Every test process, and every process a test spawns, runs torch on one
  intra-op thread: the port's CPU tensors are small, and the suite's workers
  share the machine's cores, where intra-op threads only contend (a golden
  frame: 0.26 s on one thread, 1.3 s on four).
"""

import os
import sys

from mirror_maze_tpu.native.bindings import get_library


def pytest_configure(config):
    os.environ["OMP_NUM_THREADS"] = "1"
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(1)
    if not hasattr(config, "workerinput"):
        get_library()
