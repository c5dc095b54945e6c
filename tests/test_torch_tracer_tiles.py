"""The fused tracer's plain version on multi-tile scenes, with the noise
seed row and the sky term, against the JAX package's Pallas tracer (run
interpreted, as the JAX tests run it on the CPU).

Three scenes: the 16x16 maze (its mode-1 walls fill two tiles of 128), the
same maze cut into small tiles (3 + 5 + 1, so both multi-tile groups and
their order are exercised), and the 150-quad random soup of
tests/test_pallas_tracer.py (skewed quads, two tiles). The tile-order
anchor is not the origin.

Tolerance, as tests/test_torch_tracer.py: the per-ray PCG streams are the
same on both sides, so rays agree one by one: >= 99.9% of rays within
rtol 1e-5 / atol 1e-6 on the deterministic first segment, >= 99% on
stochastic paths (a hit on an ulp edge can flip; on skewed quads XLA's dot
is a chain of fused multiply-adds where the port sums left to right; and
XLA fuses the light accumulation's multiply-add, which moves the light of
a few percent of multi-bounce rays by one ulp), and the mean light within
1e-3. The sky term goes through exp, which may
differ by an ulp between XLA and PyTorch: the same rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tools import soup_arrays
from mirror_maze_tpu.config import MazeConfig as JMaze
from mirror_maze_tpu.config import TracerConfig as JTracer
from mirror_maze_tpu.render.pallas_tracer import pack_intersection_tables, trace_paths_pallas
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu.scene.builder import Scene as JScene
from mirror_maze_tpu_torch.config import MazeConfig, TracerConfig
from mirror_maze_tpu_torch.render.fused_tracer import (
    tile_order,
    trace_paths_fused,
    trace_paths_plain,
)
from mirror_maze_tpu_torch.render.scenebuf import upload_scene
from mirror_maze_tpu_torch.scene import build_scene
from mirror_maze_tpu_torch.scene.builder import Scene

N_RAYS = 300
SEED = 7
ANCHOR = np.array([3.0, -1.0, 7.0], np.float32)
SMALL_TILES = {0: 16, 1: 32}


def _rays(n, rng, extent):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-7, 1, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX plane table, JAX packed tables, the port's scene, ray extent)."""
    out = {}
    jmaze = j_upload(j_build(JMaze(width=16, height=16)))
    pmaze = build_scene(MazeConfig(width=16, height=16))
    jsoup = j_upload(JScene(**soup_arrays()))
    for name, jdev, pscene, tbm, extent in (
            ("maze16", jmaze, pmaze, None, 79.0),
            ("maze16_small_tiles", jmaze, pmaze, SMALL_TILES, 79.0),
            ("soup150", jsoup, Scene(**soup_arrays()), None, 25.0)):
        tables = jax.tree.map(jnp.asarray, pack_intersection_tables(
            np.asarray(jdev.plane_table), tile_by_mode=tbm))
        out[name] = (jdev.plane_table, tables,
                     upload_scene(pscene, device="cpu", tile_by_mode=tbm), extent)
    return out


def _both(scene, o, d, seed_row, rows=1, **tracer):
    table, tables, p, _ = scene
    jl = np.asarray(trace_paths_pallas(
        table, jnp.asarray(o), jnp.asarray(d), jnp.int32(SEED), JTracer(**tracer),
        rows_per_block=rows, interpret=True, tables=tables, anchor=jnp.asarray(ANCHOR),
        seed_row=None if seed_row is None else jnp.asarray(seed_row)))
    pl = trace_paths_fused(
        p, torch.from_numpy(o), torch.from_numpy(d), torch.tensor([SEED], dtype=torch.int32),
        TracerConfig(**tracer), rows, anchor=torch.from_numpy(ANCHOR),
        seed_row=None if seed_row is None else torch.from_numpy(seed_row)).numpy()
    return jl, pl


def _report(name, jl, pl):
    close = np.isclose(pl, jl, rtol=1e-5, atol=1e-6).all(axis=1).mean()
    print(f"{name}: {close:.4f} within rtol 1e-5, {(pl == jl).all(axis=1).mean():.4f} bitwise")
    return close


def test_scenes_are_multi_tile(scenes):
    tiles = {name: sorted(g[2] for g in s[2].group_meta) for name, s in scenes.items()}
    assert tiles == {"maze16": [1, 1, 2], "maze16_small_tiles": [1, 3, 5], "soup150": [2]}


@pytest.mark.parametrize("with_seed_row", [False, True])
@pytest.mark.parametrize("name", ["maze16", "maze16_small_tiles", "soup150"])
def test_deterministic_segment_matches_pallas(scenes, name, with_seed_row):
    rng = np.random.default_rng(1)
    o, d = _rays(N_RAYS, rng, scenes[name][3])
    seed_row = rng.random(N_RAYS).astype(np.float32) if with_seed_row else None
    jl, pl = _both(scenes[name], o, d, seed_row, bounce_limit=1, mirror_limit=3)
    assert _report(name, jl, pl) >= 0.999
    assert jl.max() > 0


@pytest.mark.parametrize("with_seed_row", [False, True])
@pytest.mark.parametrize("name", ["maze16", "maze16_small_tiles", "soup150"])
def test_stochastic_bounces_match_pallas(scenes, name, with_seed_row):
    rng = np.random.default_rng(2)
    o, d = _rays(N_RAYS, rng, scenes[name][3])
    seed_row = rng.random(N_RAYS).astype(np.float32) if with_seed_row else None
    jl, pl = _both(scenes[name], o, d, seed_row, bounce_limit=5, mirror_limit=8)
    assert _report(name, jl, pl) >= 0.99
    assert abs(pl.mean() - jl.mean()) <= 1e-3 * abs(jl.mean())
    assert jl.mean() > 0


def test_seed_row_changes_the_streams(scenes):
    _, _, p, extent = scenes["maze16"]
    rng = np.random.default_rng(3)
    o, d = _rays(N_RAYS, rng, extent)
    args = (p, torch.from_numpy(o), torch.from_numpy(d), torch.tensor([SEED], dtype=torch.int32),
            TracerConfig(), 1)
    plain = trace_paths_fused(*args)
    zeros = trace_paths_fused(*args, seed_row=torch.zeros(N_RAYS))
    noisy = trace_paths_fused(*args, seed_row=torch.from_numpy(rng.random(N_RAYS).astype(np.float32)))
    assert torch.equal(plain, zeros)
    assert not torch.equal(plain, noisy)


@pytest.mark.parametrize("lighting_factor", [0.25, 0.0])
@pytest.mark.parametrize("name", ["soup150", "maze16"])
def test_sky_term_matches_pallas(scenes, name, lighting_factor):
    """The soup is open, so rays miss and gather the sky on every segment;
    the maze is closed, so the sky must change nothing there."""
    o, d = _rays(N_RAYS, np.random.default_rng(4), scenes[name][3])
    tracer = dict(bounce_limit=3, mirror_limit=2, sky_strength=0.7,
                  lighting_factor=lighting_factor)
    jl, pl = _both(scenes[name], o, d, None, **tracer)
    assert _report(name, jl, pl) >= 0.99
    assert abs(pl.mean() - jl.mean()) <= 1e-3 * abs(jl.mean())
    dark, _ = _both(scenes[name], o, d, None, **dict(tracer, sky_strength=0.0))
    assert (jl.sum() > dark.sum()) == (name == "soup150")


def _maze16_lights(n_rays, seed, tile_sizes, skip):
    pmaze = build_scene(MazeConfig(width=16, height=16))
    o, d = _rays(n_rays, np.random.default_rng(seed), 79.0)
    return [trace_paths_plain(
        upload_scene(pmaze, device="cpu", tile_by_mode=tbm), torch.from_numpy(o),
        torch.from_numpy(d), torch.tensor([SEED], dtype=torch.int32),
        TracerConfig(bounce_limit=5, mirror_limit=8), 2, anchor=torch.from_numpy(ANCHOR),
        skip=skip) for tbm in tile_sizes]


def test_tile_size_does_not_change_the_result():
    """With no tile skipped (``skip=False``) the result must not depend on
    how the planes are cut into tiles, apart from exact ties across tiles
    (none here: bitwise on every ray). It shows the tile-wise merge sound."""
    lights = _maze16_lights(2000, 5, (None, SMALL_TILES, {0: 8, 1: 8}, {0: 256, 1: 256}), False)
    assert float(lights[0].mean()) > 0
    for other in lights[1:]:
        assert torch.equal(other, lights[0])


@pytest.mark.parametrize("tiles", [None, SMALL_TILES])
def test_per_ray_skip_changes_only_rays_that_leave_the_world(tiles):
    """The per-ray skip against no skip at all: equal on >= 99.8% of
    random in-world rays. The rest are rays that pass through the floor or
    ceiling because that hit lies nearer than t_min; outside the world a
    wall's unbounded plane is hit outside its tile's box."""
    skipped, = _maze16_lights(20000, 6, (tiles,), True)
    dense, = _maze16_lights(20000, 6, (tiles,), False)
    same = float((skipped == dense).all(dim=1).float().mean())
    print(f"tiles {tiles}: {same:.5f} of rays equal with and without the skip")
    assert same >= 0.998


def test_tile_order_is_the_reference_argsort(scenes):
    """Groups as they stand in the tile table (most tiles first), within a
    group by squared distance of the box centre from the anchor, as
    _trace_padded's jnp.argsort gives it."""
    for name in ("maze16_small_tiles", "soup150"):
        _, tables, p, _ = scenes[name]
        want = []
        for mode, first, n in p.group_meta:
            if n > 1:
                aabbs = tables[mode][2]
                center = (aabbs[:, 0:3] + aabbs[:, 3:6]) * 0.5
                d2 = jnp.sum((center - jnp.asarray(ANCHOR)[None, :]) ** 2, axis=1)
                want += [first + int(k) for k in jnp.argsort(d2)]
        got = tile_order(p.tiles, p.group_meta, torch.from_numpy(ANCHOR))
        assert got.dtype == torch.int32 and got.tolist() == want
    _, _, single, _ = scenes["maze16"]
    assert [g[2] for g in single.group_meta][-1] == 2
