"""The fused tracer's plain version on spheres, triangles and glass (test
modes 3-7 and the dielectric stage) against the JAX package's Pallas tracer
(run interpreted, as the JAX tests run it on the CPU).

The scenes are subsets of ``primitive_zoo`` (tests/_torch_tools.py): a small
maze as the closed world plus the primitives of the named modes, in the
reference's tiles of 128 (every group one tile) and cut small
(``tile_by_mode``, several tiles a group, some of padding only). Half of the
rays aim at the primitives, so that they are hit.

Tolerance, the tracer rule of tests/test_torch_tracer_tiles.py: the per-ray
PCG streams are the same on both sides, so rays agree one by one: >= 99% of
rays within rtol 1e-5 / atol 1e-6 and the mean light within 1e-3. They are
not all bitwise: XLA-CPU compiles the interpreted kernel's body and fuses
multiply-adds where it likes (the dot's chain, ``bq*bq - q``, the refracted
direction, the light sums), the port computes them unfused; an ulp in t can
flip a hit on an edge or, with ``fresnel``, a reflect/refract decision,
which changes that ray's whole path. The bitwise share is printed.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tools import aimed_rays, primitive_zoo, scene_subset
from mirror_maze_tpu.config import TracerConfig as JTracer
from mirror_maze_tpu.render.pallas_tracer import (
    build_sphere_table,
    pack_intersection_tables,
    trace_paths_pallas,
)
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.scene.builder import Scene as JScene
from mirror_maze_tpu_torch.config import MazeConfig, TracerConfig
from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused, trace_paths_plain
from mirror_maze_tpu_torch.render.scenebuf import upload_scene
from mirror_maze_tpu_torch.scene import build_scene

N_RAYS = 600
SEED = 11
ANCHOR = np.array([2.0, -1.0, -4.0], np.float32)
SMALL = {1: 16, 3: 4, 4: 16, 5: 2, 6: 8, 7: 8}

# name -> (maze width, modes kept beside the maze's 0-2, tile_by_mode, fresnel)
CASES = {
    "spheres": (4, {3}, None, True),
    "spheres_tiled": (8, {3}, SMALL, True),
    "triangles": (4, {4}, None, True),
    "triangles_tiled": (8, {4}, SMALL, True),
    "glass_spheres": (4, {5}, None, False),
    "glass_spheres_tiled_fresnel": (8, {5}, SMALL, True),
    "glass_quads_fresnel": (4, {6}, None, True),
    "glass_quads_tiled": (8, {6}, SMALL, False),
    "glass_triangles": (4, {7}, None, False),
    "glass_triangles_tiled_fresnel": (8, {7}, SMALL, True),
    "zoo_fresnel": (8, {3, 4, 5, 6, 7}, None, True),
    "zoo_tiled": (8, {3, 4, 5, 6, 7}, SMALL, False),
    "zoo_tiled_fresnel": (8, {3, 4, 5, 6, 7}, SMALL, True),
}


def _as_jax_scene(scene):
    return JScene(**{f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)})


def _both(scene, tiles, o, d, rows=1, **tracer):
    """(Pallas interpreter's light, the port's plain version's, the port's
    uploaded scene) for one Scene of the port."""
    jscene = _as_jax_scene(scene)
    table = j_upload(jscene).plane_table
    sph = build_sphere_table(jscene) if jscene.num_spheres else None
    tables = jax.tree.map(jnp.asarray, pack_intersection_tables(
        np.asarray(table), tile_by_mode=tiles, sphere_table=sph))
    jl = np.asarray(trace_paths_pallas(
        table, jnp.asarray(o), jnp.asarray(d), jnp.int32(SEED), JTracer(**tracer),
        rows_per_block=rows, interpret=True, tables=tables, anchor=jnp.asarray(ANCHOR)))
    dev = upload_scene(scene, device="cpu", tile_by_mode=tiles)
    pl = trace_paths_fused(
        dev, torch.from_numpy(o), torch.from_numpy(d), torch.tensor([SEED], dtype=torch.int32),
        TracerConfig(**tracer), rows, anchor=torch.from_numpy(ANCHOR)).numpy()
    return jl, pl, dev


def _assert_tracer_rule(name, jl, pl):
    close = np.isclose(pl, jl, rtol=1e-5, atol=1e-6).all(axis=1).mean()
    print(f"{name}: {close:.4f} within rtol 1e-5, {(pl == jl).all(axis=1).mean():.4f} bitwise")
    assert close >= 0.99
    assert abs(pl.mean() - jl.mean()) <= 1e-3 * abs(jl.mean())
    assert jl.mean() > 0


@pytest.mark.parametrize("name", list(CASES))
def test_modes_match_pallas(name):
    width, modes, tiles, fresnel = CASES[name]
    scene = scene_subset(primitive_zoo(width), modes)
    o, d = aimed_rays(scene, N_RAYS, 1, 5.0 * width - 1.0)
    stats = {}
    jl, pl, dev = _both(scene, tiles, o, d, bounce_limit=4, mirror_limit=6, fresnel=fresnel)
    assert {g[0] for g in dev.group_meta} == {0, 1, 2} | modes
    assert (max(g[2] for g in dev.group_meta) > 1) == (tiles is not None)
    _assert_tracer_rule(name, jl, pl)
    # The rays do reach the new primitives: tests of them are counted, and
    # glass is hit where the scene has some.
    trace_paths_plain(dev, torch.from_numpy(o), torch.from_numpy(d),
                      torch.tensor([SEED], dtype=torch.int32),
                      TracerConfig(bounce_limit=4, mirror_limit=6, fresnel=fresnel), 1,
                      anchor=torch.from_numpy(ANCHOR), stats=stats)
    assert (stats["sphere_tests"] > 0) == bool(modes & {3, 5})
    assert (stats["glass_hits"] > 0) == bool(modes & {5, 6, 7})
    assert stats["plane_tests"] > 0 and stats["ray_segments"] >= N_RAYS


@pytest.mark.parametrize("fresnel", [False, True])
def test_rays_that_start_inside_a_glass_sphere(fresnel):
    """The far root: a ray inside a glass sphere hits it from within, and
    the tile skip lets it through (its box entry lies behind it)."""
    scene = scene_subset(primitive_zoo(4), {5})
    rng = np.random.default_rng(3)
    c, r = np.asarray(scene.sph_center), np.asarray(scene.sph_radius)
    pick = rng.integers(0, len(c), N_RAYS)
    inside = rng.normal(size=(N_RAYS, 3))
    inside *= (rng.uniform(0, 0.9, N_RAYS) * r[pick] / np.linalg.norm(inside, axis=1))[:, None]
    o = (c[pick] + inside).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for tiles in (None, {5: 2}):
        jl, pl, _ = _both(scene, tiles, o, d, bounce_limit=3, mirror_limit=6, fresnel=fresnel)
        _assert_tracer_rule(f"inside, fresnel={fresnel}, tiles={tiles}", jl, pl)


def test_untouched_glass_still_shifts_the_streams():
    """A glass sphere far outside the closed maze is hit by no ray, but it
    turns the dielectric stage on: with ``fresnel`` every live ray draws a
    third uniform per segment, so the paths change; with it off nothing is
    drawn and the light is bitwise the glass-free scene's."""
    maze = build_scene(MazeConfig(width=4, height=4))
    far = dataclasses.replace(
        maze, sph_center=np.float32([[500.0, 0.0, 0.0]]), sph_radius=np.float32([1.0]),
        sph_color=np.ones((1, 3), np.float32), sph_is_mirror=np.array([False]),
        sph_emission=np.zeros((1, 4), np.float32), sph_ior=np.float32([1.5]))
    o, d = aimed_rays(maze, N_RAYS, 4, 19.0)
    kw = dict(bounce_limit=4, mirror_limit=6)
    _, bare, _ = _both(maze, None, o, d, fresnel=True, **kw)
    for fresnel in (True, False):
        jl, pl, dev = _both(far, None, o, d, fresnel=fresnel, **kw)
        assert dev.has_glass
        _assert_tracer_rule(f"far glass, fresnel={fresnel}", jl, pl)
        assert np.array_equal(pl, bare) == (not fresnel)


def test_glass_free_scene_is_bitwise_what_it_was():
    """Quads of modes 0-2 only: the light of the 16x16 maze's rays is, bit
    for bit, what the plain version gave before it learnt modes 3-7 (the
    digest was taken from that version on these inputs)."""
    dev = upload_scene(build_scene(MazeConfig(width=16, height=16)), device="cpu",
                       tile_by_mode={0: 16, 1: 32})
    rng = np.random.default_rng(5)
    o = rng.uniform(-79, 79, (2000, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-7, 1, 2000)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    light = trace_paths_plain(
        dev, torch.from_numpy(o), torch.from_numpy(d), torch.tensor([SEED], dtype=torch.int32),
        TracerConfig(bounce_limit=5, mirror_limit=8), 2, anchor=torch.from_numpy(ANCHOR),
        seed_row=torch.from_numpy(rng.random(2000).astype(np.float32)))
    assert float(light.mean()) > 0
    assert hashlib.sha256(light.numpy().tobytes()).hexdigest() == GLASS_FREE_DIGEST


GLASS_FREE_DIGEST = "01219a5959577e39a972b0d8c54b2c028e1679b697fe79dbc71ab05be5372dc4"
