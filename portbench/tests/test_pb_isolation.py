"""What a run may load and where it may run: no JAX and no JAX package in a
rehearsal of any traffic mix, no result where the process holds one by its
end, nothing of the port in the reference, and no result without a card."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import run

from . import tiny

REHEARSE = """
import json, sys
from portbench import run
from portbench.tests import tiny
for cell in {cells!r}:
    rec = tiny.run_tiny(cell, seconds=0.2)
    run.check_numbers(rec, tiny.plan(cell))
print(json.dumps(run.forbidden_modules()))
"""


def python(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, **env))


@pytest.mark.parametrize("cells", [("interactive.refine",), (tiny.TURNING,)])
def test_a_rehearsal_of_each_mix_loads_no_jax(cells):
    out = python(REHEARSE.format(cells=cells))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


REPORT = """
import json, sys, types
from portbench import run
from portbench.tests import tiny
phase = {phase!r}
if phase:
    original = getattr(run, phase)

    def loading_jax(*args, **kwargs):
        sys.modules["jax"] = types.ModuleType("jax")
        return original(*args, **kwargs)
    setattr(run, phase, loading_jax)
bench = tiny.bench()
rec = tiny.run_tiny("interactive.refine", seconds=0.2, trace=phase == "rooflines")
sys.exit(run.report(bench, run.cell_of(bench, "interactive.refine"), rec))
"""


@pytest.mark.parametrize("phase", [None, "check_numbers", "rooflines"])
def test_jax_loaded_after_the_window_leaves_no_result(phase):
    """The look for JAX comes last: a module named jax that the reference
    or the roofline's count loads stops the result line."""
    out = python(REPORT.format(phase=phase))
    if phase is None:
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
    else:
        assert out.returncode == 3, out.stderr[-2000:]
        assert out.stdout.strip() == "" and "loaded jax" in out.stderr


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    """Nor does any route or roofline module."""
    modules = [f"portbench.{d}.{p.stem}" for d in ("reference", "roofline")
               for p in sorted((run.PKG / d).glob("*.py")) if p.stem != "__init__"]
    assert "portbench.reference.tracer" in modules and "portbench.roofline.tracer" in modules
    out = python(f"import importlib, sys; [importlib.import_module(m) for m in {modules!r}]; "
                 "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(ast.literal_eval(out.stdout.strip()))
    assert not top & {"jax", "jaxlib", "flax", "mirror_maze_tpu", "mirror_maze_tpu_torch"}
    for path in [*(run.PKG / "reference").glob("*.py"), *(run.PKG / "roofline").glob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] in {"numpy", "torch", "__future__", "dataclasses",
                                              "typing", "types", "importlib", "re", "sys"}, (
                    path.name, name)


def test_forbidden_modules_compare_whole_top_level_names():
    import mirror_maze_tpu_torch.runtime.step  # noqa: F401  the port's name starts with JAX's

    assert not [m for m in run.forbidden_modules() if m.startswith("mirror_maze_tpu_torch")]


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "interactive.refine", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
