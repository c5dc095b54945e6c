"""The fused tracer's texture stage (checker albedo swap) in its plain
version against the JAX package's Pallas tracer, interpreted.

Cases: the Cornell box with the checker floor (UV checker, kind 1), with a
world-checker wall besides (kind 2), with a world-checker sphere; a floor
that an untextured copy of itself ties with exactly on every hit (the tied
planes' texture rows sum, as every property does); an 8x8 maze with random
textures on half its planes, cut into many tiles.

Tolerance, the tracer rule (tests/_torch_jax_tools.py): >= 99% of rays within
rtol 1e-5 / atol 1e-6 and the mean light within 1e-3. XLA-CPU may fuse the
interpreted kernel's multiply-adds (``hx*w1x + hy*w1y``, ``o + d*t``), the
port does not, so a hit within an ulp of a cell edge can land in the other
cell: such a ray swaps its albedo and falls outside the tolerance. The share
is printed: every ray is inside on the four Cornell cases, 597 of 600 on the
textured maze.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_jax_tools import ANCHOR, SEED, assert_tracer_rule, pallas_and_plain
from _torch_tools import (
    aimed_rays,
    checker_floor,
    cornell_scene,
    textured_cornell,
    textured_maze_scene,
    tied_floor_scene,
)
from mirror_maze_tpu_torch.config import TracerConfig
from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused, trace_paths_plain
from mirror_maze_tpu_torch.render.scenebuf import upload_scene

N_RAYS = 600


# name -> (scene, ray extent, tile_by_mode)
CASES = {
    "checker_floor": (lambda: checker_floor(cornell_scene("blocks")), 4.5, None),
    "world_checker_wall": (lambda: textured_cornell("blocks"), 4.5, None),
    "checker_sphere": (lambda: textured_cornell("spheres"), 4.5, None),
    "tie_with_untextured": (tied_floor_scene, 4.5, None),
    "maze_many_tiles": (textured_maze_scene, 39.0, {0: 8, 1: 16, 2: 4, 3: 4}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_textures_match_pallas(name):
    build, extent, tiles = CASES[name]
    scene = build()
    o, d = aimed_rays(scene, N_RAYS, 1, extent)
    kw = dict(bounce_limit=4, mirror_limit=6)
    jl, pl, dev = pallas_and_plain(scene, tiles, o, d, **kw)
    assert dev.textured
    assert (max(g[2] for g in dev.group_meta) > 1) == (tiles is not None)
    assert_tracer_rule(name, jl, pl)
    # The texture is seen: textured hits are counted, and the light differs
    # from the same scene's without its textures.
    stats = {}
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.tensor([SEED], dtype=torch.int32),
            TracerConfig(**kw), 1)
    trace_paths_plain(dev, *args, anchor=torch.from_numpy(ANCHOR), stats=stats)
    assert stats["textured_hits"] > 0
    bare = dataclasses.replace(
        scene, tex_kind=np.zeros_like(scene.tex_kind),
        sph_tex_kind=np.zeros_like(scene.sph_tex_kind))
    plain = upload_scene(bare, device="cpu", tile_by_mode=tiles)
    assert not plain.textured
    unlit = trace_paths_plain(plain, *args, anchor=torch.from_numpy(ANCHOR)).numpy()
    assert not np.array_equal(unlit, pl)


def test_texture_rows_are_checked():
    """A textured scene whose texture rows do not match its records is
    refused, on any device, before anything is traced."""
    dev = upload_scene(textured_cornell("spheres"), device="cpu")
    o, d = (torch.from_numpy(a) for a in aimed_rays(textured_cornell("spheres"), 8, 1, 4.5))
    seed = torch.tensor([SEED], dtype=torch.int32)
    trace_paths_fused(dev, o, d, seed, TracerConfig(), 1)
    with pytest.raises(ValueError, match="texture rows"):
        trace_paths_fused(dev._replace(plane_tex=dev.plane_tex[:-1]), o, d, seed,
                          TracerConfig(), 1)
    with pytest.raises(ValueError, match="sphere_tex"):
        trace_paths_fused(dev._replace(sphere_tex=dev.sphere_tex.double()), o, d, seed,
                          TracerConfig(), 1)
