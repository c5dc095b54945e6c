"""The port's kernel exactness soak (``python -m
mirror_maze_tpu_torch.tools.soak_kernel``) against the repository's
``tools/soak_kernel.py`` on the CPU:

- the generator gives the JAX tool's scenes, tracer configurations, rays,
  anchors and block sizes array for array on seeds 0-9 (the tool is run
  with its tracers and upload replaced by recorders);
- on seeds 0, 1, 2, 3, 4 and 7 (quads with triangles, spheres, textures,
  spheres, glass, glass with texture) the port's plain version is held
  against the Pallas kernel in interpret mode by the tracer rule (>= 99% of
  rays within rtol 1e-5), the bitwise share printed;
- the CPU soak passes on its first 12 seeds and a failure makes it exit
  non-zero."""

import dataclasses
import os
import runpy
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_tools import as_jax_scene, assert_tracer_rule
from mirror_maze_tpu.config import TracerConfig as JTracer
from mirror_maze_tpu.render.pallas_tracer import trace_paths_pallas
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu_torch.render import trace_paths_fused, upload_scene
from mirror_maze_tpu_torch.tools import soak_kernel as soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GENERATED = 10


@pytest.fixture(scope="module")
def jax_tool_cases():
    """What the JAX tool hands its tracers for seeds 0 .. N_GENERATED - 1:
    [(scene, cfg, ori, dirs, seed, rows, anchor)]."""
    import mirror_maze_tpu.render as j_render
    import mirror_maze_tpu.render.pallas_tracer as j_pallas
    import mirror_maze_tpu.render.tracer as j_tracer

    scenes, calls = [], []

    def record_upload(scene):
        scenes.append(scene)
        return types.SimpleNamespace(plane_table=None, mxu_tables=None)

    def no_trace(dev, o, d, key, cfg):
        return np.zeros((o.shape[0], 3), np.float32)

    def record_trace(table, o, d, seed, cfg, rows_per_block, tables, anchor):
        calls.append((cfg, np.asarray(o), np.asarray(d), int(seed), rows_per_block,
                      np.asarray(anchor)))
        return np.zeros((o.shape[0], 3), np.float32)

    cache_dir = jax.config.jax_compilation_cache_dir
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_render, "upload_scene", record_upload)
        mp.setattr(j_tracer, "trace_paths", no_trace)
        mp.setattr(j_pallas, "trace_paths_pallas", record_trace)
        mp.setattr(sys, "argv", ["soak_kernel.py", str(N_GENERATED)])
        runpy.run_path(os.path.join(REPO, "tools", "soak_kernel.py"), run_name="__main__")
    finally:
        mp.undo()
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    assert len(scenes) == len(calls) == N_GENERATED
    return [(s, *c) for s, c in zip(scenes, calls)]


@pytest.mark.parametrize("seed", range(N_GENERATED))
def test_generator_is_the_jax_tools(jax_tool_cases, seed):
    scene, cfg, o, d, jseed, rows, anchor = jax_tool_cases[seed]
    case = soak.soak_case(seed)
    for f in dataclasses.fields(case.scene):
        got, want = np.asarray(getattr(case.scene, f.name)), np.asarray(getattr(scene, f.name))
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert dataclasses.asdict(case.cfg) == dataclasses.asdict(cfg)
    for got, want in ((case.ori, o), (case.dirs, d), (case.anchor, anchor)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (case.seed, case.rows) == (jseed, rows)


def test_generator_covers_every_case():
    """Seeds 0-9 hold every kind of scene the soak is for."""
    cases = [soak.soak_case(s) for s in range(N_GENERATED)]
    kinds = {s: (c.scene.num_spheres > 0, bool((np.asarray(c.scene.kind) == 3).any()),
                 bool((np.asarray(c.scene.ior) > 0).any()),
                 bool((np.asarray(c.scene.tex_kind) > 0).any()))
             for s, c in enumerate(cases)}
    assert kinds[0] == (False, True, False, False)      # quads and triangles
    assert kinds[1][0] and kinds[2][3] and kinds[4][2]  # spheres, textures, glass
    assert kinds[7][2] and kinds[7][3] and kinds[7][0]  # glass and texture, spheres
    degenerate = [np.asarray(c.scene.v)[:: max(7, c.n // 4)] for c in cases]
    assert all((v == 0).all() for v in degenerate)
    assert all(c.scene.derived().valid.sum() < c.n for c in cases)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 7])
def test_plain_version_against_the_interpreter(seed):
    case = soak.soak_case(seed)
    jdev = j_upload(as_jax_scene(case.scene))
    want = np.asarray(trace_paths_pallas(
        jdev.plane_table, jnp.asarray(case.ori), jnp.asarray(case.dirs), jnp.int32(seed),
        JTracer(**dataclasses.asdict(case.cfg)), rows_per_block=case.rows,
        tables=jdev.mxu_tables, anchor=jnp.asarray(case.anchor), interpret=True))
    dev = upload_scene(case.scene, device="cpu")
    got = trace_paths_fused(dev, torch.from_numpy(case.ori), torch.from_numpy(case.dirs),
                            torch.tensor([seed], dtype=torch.int32), case.cfg, case.rows,
                            anchor=torch.from_numpy(case.anchor)).numpy()
    assert dev.plane_table.shape[0] == jdev.plane_table.shape[0] < case.n
    assert_tracer_rule(f"soak seed {seed}", want, got)


def test_cpu_soak_passes_and_a_failure_exits_nonzero(capsys, monkeypatch):
    assert soak.main(["12", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 13 and all(line.endswith(" OK") for line in lines[:12])
    assert lines[-1].endswith("FAILURES: []")
    check = soak.check_case
    monkeypatch.setattr(soak, "check_case",
                        lambda case, dev: {**check(case, dev), "ok": case.seed != 1})
    assert soak.main(["3", "--device", "cpu"]) == 1
    assert "FAILURES: [(1," in capsys.readouterr().out
