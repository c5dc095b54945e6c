"""What the CUDA tracer's design rests on, checked on the CPU: the share of
a warp's lanes that carry a live ray (``utils/profiling.py
warp_lane_share``), from the plain version's segments per ray and its warp
statistics, on mazes in many tiles, spheres, glass, meshes and textures."""

import numpy as np
import pytest
import torch

from _torch_tools import (
    aimed_rays,
    checker_floor,
    cornell_scene,
    mesh_gallery_scene,
    primitive_zoo,
    soup_arrays,
    textured_cornell,
    textured_maze_scene,
)
from mirror_maze_tpu_torch.config import MazeConfig, TracerConfig
from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_plain
from mirror_maze_tpu_torch.render.scenebuf import upload_scene
from mirror_maze_tpu_torch.scene import build_scene
from mirror_maze_tpu_torch.scene.builder import Scene
from mirror_maze_tpu_torch.utils.profiling import warp_lane_share

def test_warp_lane_share_hand_count():
    # Warps of 4: [1, 2, 3, 4] runs 4 segments with 10 lane-segments alive,
    # [2, 2, 2, 2] runs 2 with 8: 18 of 4 * 6.
    assert warp_lane_share(torch.tensor([1, 2, 3, 4, 2, 2, 2, 2]), warp=4) == 18 / 24
    # A partial last warp counts its empty lanes as idle.
    assert warp_lane_share([3, 1, 2], warp=4) == 6 / 12
    assert warp_lane_share(np.full(64, 5)) == 1.0
    segs = np.zeros(64, int)
    segs[0], segs[32] = 7, 3               # one live lane a warp
    assert warp_lane_share(segs) == pytest.approx(10 / (32 * 10))
    assert warp_lane_share([]) == 0.0


# name -> (scene, ray extent, tile_by_mode)
SCENES = {
    "maze_tiles": (lambda: build_scene(MazeConfig(width=16, height=16)), 79.0, {0: 16, 1: 32}),
    "zoo": (lambda: primitive_zoo(8), 39.0, None),
    "zoo_tiles": (lambda: primitive_zoo(8), 39.0, {1: 16, 3: 4, 4: 16, 5: 2, 6: 8, 7: 8}),
    "soup": (lambda: Scene(**soup_arrays()), 20.0, None),
    "cornell_glass": (lambda: cornell_scene("glass"), 4.5, None),
    "cornell_spheres": (lambda: cornell_scene("spheres"), 4.5, None),
    "cornell_checker": (lambda: textured_cornell("blocks"), 4.5, None),
    "mesh": (mesh_gallery_scene, 6.0, None),
    "textured_maze_tiles": (textured_maze_scene, 39.0, {0: 8, 1: 16, 2: 4, 3: 4}),
    "mesh_checker": (lambda: checker_floor(mesh_gallery_scene()), 6.0, None),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_warp_lane_share_of_the_plain_tracer(name):
    """The per-ray segments sum to the live ray-segments, the share is their
    count over 32 times the warp-segments the plain version counts itself,
    and grouped by blocks of 128 rays the segments give the diagnostics'
    rows 3 and 7."""
    build, extent, tiles = SCENES[name]
    scene = build()
    dev = upload_scene(scene, device="cpu", tile_by_mode=tiles)
    o, d = (torch.from_numpy(a) for a in aimed_rays(scene, 1024, 3, extent))
    seed = torch.tensor([7], dtype=torch.int32)
    tracer = TracerConfig(bounce_limit=4, mirror_limit=6)
    stats = {}
    light = trace_paths_plain(dev, o, d, seed, tracer, 1, stats=stats)
    segs = stats["segments_per_ray"]
    assert segs.shape == (1024,) and segs.dtype == torch.int32
    assert int(segs.min()) >= 1 and int(segs.max()) <= tracer.max_segments
    assert int(segs.sum()) == stats["ray_segments"]
    share = warp_lane_share(segs)
    assert share == pytest.approx(stats["ray_segments"] / (32 * stats["warp_segments"]))
    assert 0.0 < share <= 1.0
    # A warp scans a walked tile when one of its rays reaches it.
    assert stats["tile_visits"] / 32 <= stats["warp_tile_visits"] <= stats["tile_visits"]
    light2, diag = trace_paths_plain(dev, o, d, seed, tracer, 1, return_block_segments=True)
    assert torch.equal(light, light2)
    blocks = segs.view(-1, 128)
    assert torch.equal(diag[0], blocks.max(dim=1).values)
    assert torch.equal(diag[4], blocks.sum(dim=1, dtype=torch.int32))


def test_warp_lane_share_of_a_walked_maze_is_partial():
    """On the 16x16 maze in small tiles rays die at different segments: the
    warps keep between a third and all of their lanes busy, and walk tiles."""
    scene = build_scene(MazeConfig(width=16, height=16))
    dev = upload_scene(scene, device="cpu", tile_by_mode={0: 16, 1: 32})
    o, d = (torch.from_numpy(a) for a in aimed_rays(scene, 1024, 3, 79.0))
    stats = {}
    trace_paths_plain(dev, o, d, torch.tensor([7], dtype=torch.int32),
                      TracerConfig(bounce_limit=4, mirror_limit=6), 1, stats=stats)
    assert 0.3 < warp_lane_share(stats["segments_per_ray"]) < 1.0
    assert stats["warp_tile_visits"] > 0
