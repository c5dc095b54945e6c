"""The fused tracer's plain version against the JAX package's Pallas tracer
(run as the JAX tests run it on the CPU: interpreted). The CUDA kernel
against its plain version is in tests/test_torch_cuda.py.

Rays follow tests/test_pallas_tracer.py's ``_rays`` recipe (uniform
origins inside the 4x4 maze, normal-distributed unit directions), an odd
count so the reference pads its last block. The per-ray PCG streams are
the same on both sides, so even the stochastic multi-bounce light agrees
ray for ray; only a hit on an ulp edge could flip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_maze_tpu.config import MazeConfig as JMaze
from mirror_maze_tpu.config import TracerConfig as JTracer
from mirror_maze_tpu.render.pallas_tracer import trace_paths_pallas
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch.config import MazeConfig, TracerConfig
from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused, trace_paths_plain
from mirror_maze_tpu_torch.render.scenebuf import upload_scene
from mirror_maze_tpu_torch.scene import build_scene

N_RAYS = 385
SEED = 7


def _rays(n, rng, extent=15.0):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-7, 1, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def scenes():
    j = j_upload(j_build(JMaze(width=4, height=4)))
    p = upload_scene(build_scene(MazeConfig(width=4, height=4)), device="cpu")
    return j, p


def _both(scenes, o, d, bounce, mirror, rows):
    j, p = scenes
    jl = np.asarray(trace_paths_pallas(
        j.plane_table, jnp.asarray(o), jnp.asarray(d), jnp.int32(SEED),
        JTracer(bounce_limit=bounce, mirror_limit=mirror),
        rows_per_block=rows, interpret=True, tables=j.mxu_tables))
    pl = trace_paths_fused(
        p.planes, p.mode_counts, torch.from_numpy(o), torch.from_numpy(d),
        torch.tensor([SEED], dtype=torch.int32),
        TracerConfig(bounce_limit=bounce, mirror_limit=mirror), rows).numpy()
    return jl, pl


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("mirror", [1, 2, 5])
def test_deterministic_segment_matches_pallas(scenes, mirror, rows):
    o, d = _rays(N_RAYS, np.random.default_rng(mirror * 10 + rows))
    jl, pl = _both(scenes, o, d, 1, mirror, rows)
    close = np.isclose(pl, jl, rtol=1e-5, atol=1e-6).all(axis=1)
    assert close.mean() >= 0.999, close.mean()
    assert jl.max() > 0


@pytest.mark.parametrize("rows", [1, 2])
def test_stochastic_bounces_match_pallas(scenes, rows):
    o, d = _rays(N_RAYS, np.random.default_rng(100 + rows))
    jl, pl = _both(scenes, o, d, 5, 8, rows)
    close = np.isclose(pl, jl, rtol=1e-5, atol=1e-6).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(pl.mean() - jl.mean()) <= 1e-3 * abs(jl.mean())
    assert jl.mean() > 0


def test_block_size_changes_the_streams_not_the_launch(scenes):
    """The PCG grouping follows the reference's B = rows*128: B changes the
    stochastic light, and the plain version's internal ray chunking does
    not."""
    from mirror_maze_tpu_torch.render import fused_tracer

    _, p = scenes
    o, d = _rays(N_RAYS, np.random.default_rng(5))
    args = (p.planes, p.mode_counts, torch.from_numpy(o), torch.from_numpy(d),
            torch.tensor([SEED], dtype=torch.int32), TracerConfig(bounce_limit=5, mirror_limit=8))
    a = trace_paths_plain(*args, 1)
    b = trace_paths_plain(*args, 2)
    assert not torch.equal(a, b)
    old = fused_tracer.PLAIN_CHUNK
    try:
        fused_tracer.PLAIN_CHUNK = 100
        c = trace_paths_plain(*args, 1)
    finally:
        fused_tracer.PLAIN_CHUNK = old
    assert torch.equal(a, c)


def test_wrapper_checks_inputs(scenes):
    _, p = scenes
    o, d = _rays(8, np.random.default_rng(0))
    seed = torch.tensor([SEED], dtype=torch.int32)
    cfg = TracerConfig()
    with pytest.raises(ValueError):
        trace_paths_fused(p.planes, p.mode_counts, torch.from_numpy(o).double(),
                          torch.from_numpy(d), seed, cfg, 1)
    with pytest.raises(ValueError):
        trace_paths_fused(p.planes, p.mode_counts, torch.from_numpy(o),
                          torch.from_numpy(d[:4]), seed, cfg, 1)
    with pytest.raises(ValueError):
        trace_paths_fused(p.planes, p.mode_counts, torch.from_numpy(o),
                          torch.from_numpy(d), seed.long(), cfg, 1)
