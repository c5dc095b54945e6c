"""Host scene build, plane table, tile table, noise texture and collision
boxes: the port against the JAX package, bitwise."""

import dataclasses

import numpy as np
import pytest

from _torch_tools import soup_arrays
from mirror_maze_tpu.config import MazeConfig as JMaze
from mirror_maze_tpu.render.pallas_tracer import pack_intersection_tables
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu.scene.bvh import build_bvh as j_bvh
from mirror_maze_tpu.scene.builder import Scene as JScene
from mirror_maze_tpu.scene.bvh import traversal_bounds as j_bounds
from mirror_maze_tpu.utils import noise as j_noise
from mirror_maze_tpu_torch.config import MazeConfig
from mirror_maze_tpu_torch.render.scenebuf import plane_records, tile_table, upload_scene
from mirror_maze_tpu_torch.scene import build_scene
from mirror_maze_tpu_torch.scene.bvh import build_bvh, traversal_bounds
from mirror_maze_tpu_torch.utils import noise

CASES = [(w, seed, rng) for w in (4, 10) for seed in (0, 1)
         for rng in ("numpy", "reference")]


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("w,seed,rng", CASES)
def test_scene_arrays_bitwise(w, seed, rng):
    j = j_build(JMaze(width=w, height=w, seed=seed, rng=rng))
    p = build_scene(MazeConfig(width=w, height=w, seed=seed, rng=rng))
    for f in dataclasses.fields(p):
        _bitwise(getattr(p, f.name), getattr(j, f.name))
    jd, pd = j.derived(), p.derived()
    for f in dataclasses.fields(pd):
        _bitwise(getattr(pd, f.name), getattr(jd, f.name))


@pytest.mark.parametrize("w,seed,rng", CASES[::3])
def test_plane_table_and_leaf_boxes_bitwise(w, seed, rng):
    j = j_build(JMaze(width=w, height=w, seed=seed, rng=rng))
    jdev = j_upload(j)
    pdev = upload_scene(build_scene(MazeConfig(width=w, height=w, seed=seed, rng=rng)),
                        device="cpu")
    _bitwise(pdev.plane_table.numpy(), np.asarray(jdev.plane_table))
    _bitwise(pdev.leaf_min.numpy(), np.asarray(jdev.leaf_min))
    _bitwise(pdev.leaf_max.numpy(), np.asarray(jdev.leaf_max))
    # The tracer records are the table's first 19 columns plus the test mode,
    # in table order, grouped mode 0, 1, 2 as the kernel's groups are.
    table = pdev.plane_table.numpy()
    rec = pdev.planes.numpy()
    _bitwise(rec[:, :19], table[:, :19])
    _bitwise(rec[:, 19], table[:, 26])
    n0, n1, n2 = pdev.mode_counts
    assert (n0, n1, n2) == tuple(int((table[:, 26] == m).sum()) for m in (0, 1, 2))
    assert np.all(np.diff(rec[:, 19]) >= 0)


def test_bvh_matches_numpy_builder():
    s = j_build(JMaze(width=10, height=10))
    j = j_bvh(s.origin, s.u, s.v, backend="numpy")
    p = build_bvh(s.origin, s.u, s.v)
    for f in ("aabb_min", "aabb_max", "left_first", "count", "prim_index"):
        _bitwise(getattr(p, f), getattr(j, f))
    assert traversal_bounds(p.left_first, p.count) == j_bounds(j.left_first, j.count)


def test_interactive_scene_is_the_kernel_slice():
    """config_interactive's scene: 72 live planes in three single-tile
    groups (modes 0-2), no spheres, glass or textures — what the fused
    tracer traces."""
    from mirror_maze_tpu_torch.config import config_interactive

    dev = upload_scene(build_scene(config_interactive().maze), device="cpu")
    assert dev.num_planes == 72
    assert all(n > 0 for n in dev.mode_counts)
    assert dev.leaf_min.shape == (78, 3)


def test_unported_primitives_raise():
    table = np.zeros((2, 40), np.float32)
    table[:, 19] = 1.0
    table[1, 26] = 3.0                     # a triangle
    with pytest.raises(NotImplementedError):
        plane_records(table)


def _soup_table():
    return np.asarray(j_upload(JScene(**soup_arrays())).plane_table)


def _maze_table(w):
    return np.asarray(j_upload(j_build(JMaze(width=w, height=w))).plane_table)


TILE_CASES = {
    "maze16": (lambda: _maze_table(16), None, [1, 1, 2]),
    "maze4_tiles_of_8": (lambda: _maze_table(4), {0: 8, 1: 8}, [1, 1, 1]),
    "maze8_tiles_of_8": (lambda: _maze_table(8), {0: 8, 1: 8}, [1, 1, 5]),
    "maze16_small_tiles": (lambda: _maze_table(16), {0: 16, 1: 32}, [1, 3, 5]),
    "maze16_tiles_of_4": (lambda: _maze_table(16), {0: 4, 1: 4, 2: 4}, [2, 12, 34]),
    "soup150": (_soup_table, None, [2]),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_table_bitwise(case):
    """The tile boxes are the reference's per-mode ``aabbs`` bit for bit,
    the tiles cover each mode's rows in order, and the groups stand single
    tiles first, then most tiles first."""
    make, tbm, n_tiles = TILE_CASES[case]
    table = make()
    tiles, meta = tile_table(table, tbm)
    packed = pack_intersection_tables(table, tile_by_mode=tbm)
    assert sorted(g[2] for g in meta) == n_tiles
    assert [g[0] for g in meta] == sorted(
        (g[0] for g in meta), key=lambda m: (packed[m][2].shape[0] > 1, -packed[m][2].shape[0]))
    assert sum(g[2] for g in meta) == len(tiles)
    kinds = table[:, 26]
    for mode, first, n in meta:
        _bitwise(tiles[first:first + n, 0:6], np.asarray(packed[mode][2])[:, 0:6])
        rows = np.flatnonzero(kinds == mode)
        starts, counts = tiles[first:first + n, 6], tiles[first:first + n, 7]
        assert starts[0] == rows[0] and counts.sum() == len(rows)
        assert np.all(starts[1:] == np.minimum(starts[:-1] + counts[:-1], rows[-1] + 1))


def test_tile_table_rejects_an_unordered_table():
    with pytest.raises(ValueError):
        tile_table(_maze_table(4)[::-1])


def test_uploaded_scene_carries_tiles_and_noise():
    dev = upload_scene(build_scene(MazeConfig(width=16, height=16)), device="cpu")
    tiles, meta = tile_table(dev.plane_table.numpy())
    _bitwise(dev.tiles.numpy(), tiles)
    assert dev.group_meta == meta == ((0, 0, 1), (2, 1, 1), (1, 2, 2))
    _bitwise(dev.noise.numpy(), noise.generate_noise())
    custom = np.full((4, 4), 0.5, np.float32)
    small = upload_scene(build_scene(MazeConfig(width=4, height=4)), device="cpu", noise=custom,
                         tile_by_mode={1: 8})
    _bitwise(small.noise.numpy(), custom)


@pytest.mark.parametrize("size,seed", [(512, 0), (64, 3)])
def test_generate_noise_bitwise(size, seed):
    _bitwise(noise.generate_noise(size, seed), j_noise.generate_noise(size, seed))


def test_sample_noise_bitwise():
    import torch

    tex = j_noise.generate_noise(64, 1)
    pix = np.random.default_rng(0).integers(0, 4000, (500, 2)).astype(np.int32)
    got = noise.sample_noise(torch.from_numpy(tex), torch.from_numpy(pix))
    _bitwise(got.numpy(), np.asarray(j_noise.sample_noise(tex, pix)))
