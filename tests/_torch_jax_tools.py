"""Helpers of the port's tests that run the JAX package (tests/_torch_tools.py
imports no JAX, so that the GPU machine can use it): one Scene of the port
through the Pallas tracer, interpreted as the JAX tests run it on the CPU,
and through the port's plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mirror_maze_tpu.config import TracerConfig as JTracer
from mirror_maze_tpu.render.pallas_tracer import (
    build_sphere_table,
    pack_intersection_tables,
    trace_paths_pallas,
)
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.scene.builder import Scene as JScene
from mirror_maze_tpu_torch.config import TracerConfig
from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused
from mirror_maze_tpu_torch.render.scenebuf import upload_scene

SEED = 11
ANCHOR = np.array([2.0, -1.0, -4.0], np.float32)


def as_jax_scene(scene) -> JScene:
    return JScene(**{f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)})


def pallas_and_plain(scene, tiles, o, d, rows=1, diag=False, **tracer):
    """(the Pallas interpreter's result, the port's plain version's, the
    port's uploaded scene) for one Scene of the port and rays ``o``, ``d``;
    ``tiles`` is ``tile_by_mode``. A result is the light [R, 3], or with
    ``diag`` (light, diagnostics [5, blocks] as integers)."""
    jscene = as_jax_scene(scene)
    table = j_upload(jscene).plane_table
    sph = build_sphere_table(jscene) if jscene.num_spheres else None
    tables = jax.tree.map(jnp.asarray, pack_intersection_tables(
        np.asarray(table), tile_by_mode=tiles, sphere_table=sph))
    ref = trace_paths_pallas(
        table, jnp.asarray(o), jnp.asarray(d), jnp.int32(SEED), JTracer(**tracer),
        rows_per_block=rows, interpret=True, tables=tables, anchor=jnp.asarray(ANCHOR),
        return_block_segments=diag)
    dev = upload_scene(scene, device="cpu", tile_by_mode=tiles)
    got = trace_paths_fused(
        dev, torch.from_numpy(o), torch.from_numpy(d), torch.tensor([SEED], dtype=torch.int32),
        TracerConfig(**tracer), rows, anchor=torch.from_numpy(ANCHOR),
        return_block_segments=diag)
    if diag:
        return ((np.asarray(ref[0]), np.asarray(ref[1]).astype(np.int64)),
                (got[0].numpy(), got[1].numpy().astype(np.int64)), dev)
    return np.asarray(ref), got.numpy(), dev


def assert_tracer_rule(name, jl, pl) -> float:
    """The tracer rule: >= 99% of rays within rtol 1e-5 / atol 1e-6 and the
    mean light within 1e-3; prints and returns the bitwise share."""
    close = np.isclose(pl, jl, rtol=1e-5, atol=1e-6).all(axis=1).mean()
    exact = (pl == jl).all(axis=1).mean()
    print(f"{name}: {close:.4f} within rtol 1e-5, {exact:.4f} bitwise")
    assert close >= 0.99
    assert abs(pl.mean() - jl.mean()) <= 1e-3 * abs(jl.mean())
    assert jl.mean() > 0
    return float(exact)
