"""Host scene build, plane table and collision boxes: the port against the
JAX package, bitwise."""

import dataclasses

import numpy as np
import pytest

from mirror_maze_tpu.config import MazeConfig as JMaze
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu.scene.bvh import build_bvh as j_bvh
from mirror_maze_tpu.scene.bvh import traversal_bounds as j_bounds
from mirror_maze_tpu_torch.config import MazeConfig
from mirror_maze_tpu_torch.render.scenebuf import plane_records, upload_scene
from mirror_maze_tpu_torch.scene import build_scene
from mirror_maze_tpu_torch.scene.bvh import build_bvh, traversal_bounds

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
