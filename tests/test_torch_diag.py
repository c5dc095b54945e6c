"""The fused tracer's per-block diagnostics (the reference kernel's output
rows 3-7) in the plain version against the JAX package's Pallas tracer,
interpreted, and ``tracer_segment_histogram`` built on them.

Row 3 (segments a block ran) and row 7 (live rays entering its segments,
summed) follow from which rays are alive when; rows 4-6 (tiles evaluated)
come from the block-wide vote over the per-ray slab tests. All five rows are
held exactly equal, on every block: on the closed mazes (4x4 in one tile a
group; 16x16 in the reference's tiles and cut small), on the zoo of all
eight modes cut into many tiles (tiles of padding only among them, whose
inverted boxes pass the slab test and count), and on the open random soup,
whose rays leave the world. There the port's per-ray skip and the
reference's per-block skip may give a ray different running hits, and the
light differs by ulps on a few rays of most blocks (the bitwise share is
printed), but on these rays no count moved.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_jax_tools import as_jax_scene, assert_tracer_rule, pallas_and_plain
from _torch_tools import aimed_rays, primitive_zoo, soup_arrays
from mirror_maze_tpu.config import EngineConfig as JEngine
from mirror_maze_tpu.config import TracerConfig as JTracer
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.utils.profiling import tracer_segment_histogram as j_histogram
from mirror_maze_tpu_torch.config import EngineConfig, MazeConfig, TracerConfig
from mirror_maze_tpu_torch.render.scenebuf import upload_scene
from mirror_maze_tpu_torch.scene import build_scene
from mirror_maze_tpu_torch.scene.builder import Scene
from mirror_maze_tpu_torch.utils.profiling import tracer_segment_histogram

ZOO_TILES = {1: 16, 3: 4, 4: 16, 5: 2, 6: 8, 7: 8}
# name -> (scene, ray extent, tile_by_mode, rays)
CASES = {
    "maze4": (lambda: build_scene(MazeConfig(width=4, height=4)), 19.0, None, 600),
    "maze16": (lambda: build_scene(MazeConfig(width=16, height=16)), 79.0, None, 700),
    "maze16_small_tiles": (lambda: build_scene(MazeConfig(width=16, height=16)), 79.0,
                           {0: 16, 1: 32}, 700),
    "zoo_tiled": (lambda: primitive_zoo(8), 39.0, ZOO_TILES, 600),
    "soup": (lambda: Scene(**soup_arrays()), 20.0, None, 600),
}


@pytest.mark.parametrize("name", list(CASES))
def test_diagnostics_match_pallas(name):
    build, extent, tiles, n_rays = CASES[name]
    scene = build()
    o, d = aimed_rays(scene, n_rays, 1, extent)
    # B = 128 rays: the wavefront is not a whole number of blocks, so the
    # last block is padded with zero rays on both sides.
    (jl, jd), (pl, pd), dev = pallas_and_plain(
        scene, tiles, o, d, rows=1, diag=True, bounce_limit=4, mirror_limit=6, fresnel=False)
    assert pd.shape == jd.shape == (5, -(-n_rays // 128))
    if name != "soup":
        assert_tracer_rule(name, jl, pl)
    same = (pl == jl).all(axis=1)
    block_same = np.array([same[b * 128:(b + 1) * 128].all() for b in range(pd.shape[1])])
    share = [(pd[r] == jd[r]).mean() for r in range(5)]
    print(f"{name}: {block_same.mean():.3f} of blocks bitwise in the light; rows 3-7 equal "
          f"on {', '.join(f'{s:.3f}' for s in share)} of blocks")
    np.testing.assert_array_equal(pd, jd)
    assert (pd[0] >= 1).all() and (pd[4] >= 128).all()
    n_single = sum(1 for g in dev.group_meta if g[2] == 1)
    if all(g[2] == 1 for g in dev.group_meta):
        # One tile a group: the tile rows follow from the segments.
        np.testing.assert_array_equal(pd[1], n_single * pd[0])
        np.testing.assert_array_equal(pd[3], n_single * np.minimum(pd[0], 3))
    assert (pd[2] >= n_single).all() and (pd[1] >= pd[3]).all() and (pd[3] >= pd[2]).all()


def test_diagnostics_leave_the_light_alone():
    """Asking for the diagnostics changes no ray's light, padded or not."""
    scene = build_scene(MazeConfig(width=16, height=16))
    o, d = aimed_rays(scene, 300, 2, 79.0)
    from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused

    dev = upload_scene(scene, device="cpu")
    args = (dev, torch.from_numpy(o), torch.from_numpy(d), torch.tensor([3], dtype=torch.int32),
            TracerConfig(bounce_limit=3, mirror_limit=4), 1)
    light, diag = trace_paths_fused(*args, return_block_segments=True)
    assert torch.equal(light, trace_paths_fused(*args))
    assert diag.dtype == torch.int32 and tuple(diag.shape) == (5, 3)


@pytest.mark.parametrize("width,rows", [(4, 1), (16, 2)])
def test_segment_histogram_matches_the_reference(width, rows):
    scene = build_scene(MazeConfig(width=width, height=width))
    o, d = aimed_rays(scene, 1024, 3, 5.0 * width - 1.0)
    anchor = np.float32([1.0, -1.0, 2.0])
    tracer = dict(bounce_limit=3, mirror_limit=4)
    want = j_histogram(j_upload(as_jax_scene(scene)), JEngine(tracer=JTracer(**tracer)),
                       jnp.asarray(o), jnp.asarray(d), rows_per_block=rows,
                       anchor=jnp.asarray(anchor))
    got = tracer_segment_histogram(
        upload_scene(scene, device="cpu"), EngineConfig(tracer=TracerConfig(**tracer)),
        torch.from_numpy(o), torch.from_numpy(d), rows_per_block=rows,
        anchor=torch.from_numpy(anchor))
    assert got.keys() == want.keys()
    assert got["histogram"] == want["histogram"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
