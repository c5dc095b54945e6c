"""The test harness's process-wide rules (the repository's root conftest.py),
checked in whichever test process runs this file: a worker of the suite or a
plain run."""

import os
import shutil
import subprocess
import sys

import torch

from mirror_maze_tpu.native.bindings import native_available


def test_the_native_library_is_built_before_the_workers_collect():
    # Built once before the workers start; a worker that built it during its
    # own collection could race the others and hold a failed build for life.
    assert native_available() or shutil.which("g++") is None


def test_torch_runs_on_one_thread_in_every_test_process():
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
    # A process a test spawns with this environment inherits the rule.
    out = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    assert out.split() == ["1"]
