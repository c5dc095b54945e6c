"""The ``interactive-bvh`` configuration's segment path against the
benchmark's plain reference route ``segments`` (portbench/reference/
segments.py), on the CPU at a test size: the port's plain walk and plain
shade, ray for ray, and the whole step through ``make_scan_step``.

The tolerance is none: the route evaluates the port's float32 operations in
the same order (dots left to right, true divisions, correctly rounded
roots, the draw's steps each rounded once), so any bit that differs is a
fault of one or the other. A route with a step left out must fail."""

import numpy as np
import pytest
import torch

from _torch_tools import frame1_rays
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.render import intersect
from mirror_maze_tpu_torch.render.pipeline import derive_traversal_bounds, scene_nearest_fn
from mirror_maze_tpu_torch.render.scenebuf import upload_scene
from mirror_maze_tpu_torch.render.tracer import segment_draws, trace_paths
from mirror_maze_tpu_torch.scene import build_scene
from portbench import run
from portbench.reference import prng as ref_prng
from portbench.reference import segments, sim
from portbench.tests import tiny

CELL = "interactive-bvh.refine"


def small_config(size: int, seed: int = 0) -> dict:
    """interactive-bvh's configuration file at a test size: a size x size
    maze of the given seed with the camera inside it, 64 x 48 pixels, 4
    samples, 16 chunks a frame, 5 + 3 segments."""
    cfg = tiny.config("interactive-bvh")
    e = cfg["engine"]
    e["maze"].update(width=size, height=size, seed=seed)
    e["camera"]["spawn"] = [-5.0, 0.0, -5.0 * size + 5.0]
    e["screen"].update(width=64, height=48, chunks_per_frame=16)
    e["tracer"].update(bounce_limit=5, mirror_limit=3)
    return cfg


def frame_of(tkey: torch.Tensor) -> sim.Frame:
    """A frame whose only draw the route reads is its tracer key."""
    key = tuple(int(k) & prng.MASK for k in tkey.tolist())
    return sim.Frame(1, None, None, None, None, 0, None, None, key, 0, None)


def both(size: int, seed: int):
    """(the port's light, the route's light and statistics) of frame 1 of an
    idle start on a maze of ``size`` drawn from ``seed``."""
    cfg_file = small_config(size, seed)
    cfg = run.engine_config(cfg_file["engine"])
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    ori, dirs, tkey = frame1_rays(cfg, scene, with_key=True)
    port = trace_paths(scene.prims, ori, dirs, tkey, cfg.tracer, scene_nearest_fn(scene, cfg))
    stats = {}
    route = segments.trace(segments.build(cfg_file["engine"], "cpu"), ori, dirs,
                           torch.arange(ori.shape[0]), [(frame_of(tkey), ori.shape[0])], None,
                           cfg_file["engine"]["tracer"], stats=stats)
    return port, route, stats, (cfg, scene, ori, dirs)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("size,seed", [(4, 0), (4, 5), (6, 3), (6, 2 ** 31 + 7)])
def test_the_segment_path_is_the_routes_ray_for_ray(size, seed):
    port, route, stats, _ = both(size, seed)
    assert torch.equal(bits(port), bits(route))
    # The frame is lit, and its paths bounce past the first segments.
    assert (port > 0).float().mean() > 0.2
    assert stats["alive"][0] == port.shape[0] and stats["alive"][3] > 0


@pytest.mark.parametrize("size,seed", [(4, 0), (4, 5), (6, 3), (6, 2 ** 31 + 7)])
def test_the_routes_walk_counts_the_plain_walks_work(size, seed):
    """Its first segment's node visits, slab and primitive tests are the
    plain walk's (``stats``: visits, interior visits, two slab tests each,
    and primitive tests) on the same rays; ``walk_*`` sum its segments, as
    the walk kernel's counters do."""
    _, _, stats, (cfg, scene, ori, dirs) = both(size, seed)
    depth, leaf = derive_traversal_bounds(scene, cfg, None, None)
    plain = {}
    intersect.nearest_hit_bvh(scene.prims, ori, dirs, cfg.tracer.t_min, depth, leaf,
                              stats=plain)
    assert stats["visits"][0] == int(plain["visits"])
    assert stats["slab_tests"][0] == 2 * int(plain["interior"])
    assert stats["prim_tests"][0] == int(plain["tests"])
    assert stats["walk_rays"] == sum(stats["alive"]) and stats["rays"] == ori.shape[0]
    assert stats["walk_nodes"] == sum(stats["visits"]) > stats["walk_rays"] > 0
    # A visit is an interior node's slab pair or a leaf's primitive tests.
    assert all(v > s // 2 for v, s in zip(stats["visits"], stats["slab_tests"]) if v)
    assert stats["kept"][:-1] == stats["alive"][1:]


@pytest.mark.parametrize("it,n_rays", [(0, 1000), (7, 2 ** 17 + 3), (12, 12345)])
def test_the_routes_draws_are_the_ports_at_any_ray_ids(it, n_rays):
    """Segment ``it``'s normal triples of an R-ray wavefront, at positions
    drawn anywhere in it, as the port's ``segment_draws`` makes them."""
    key = prng.fold_in(prng.PRNGKey(2 ** 31 + it), n_rays)
    g, u3 = segment_draws(key, None, it, n_rays, fresnel=False)
    ids = torch.from_numpy(np.random.default_rng(it).choice(n_rays, 500, replace=False))
    ids = torch.cat([ids, torch.tensor([0, n_rays - 1])])
    k1, k2 = (int(k) for k in key.tolist())
    got = segments.normals(ref_prng.fold_in((k1, k2), it), ids)
    assert u3 is None and torch.equal(bits(got), bits(g[ids]))


def run_small(seed: int) -> dict:
    bench = tiny.bench()
    cell = run.cell_of(bench, CELL)
    return run.run_cell(bench, cell, seed, 0.3, False, "cpu", cfg_file=small_config(6, 1),
                        mix=tiny.mix("refine"))


@pytest.mark.parametrize("seed", [2 ** 31 + 12, 2 ** 33 + 11])
def test_the_configuration_through_make_scan_step_is_its_references(seed):
    """``interactive-bvh`` on the normal path (make_scan_step, the plain walk
    and shade on the CPU) against the route through the benchmark's check:
    every state entry, pose and display value equal."""
    rec = run_small(seed)
    assert rec["cfg_file"]["engine"]["intersector"] == "bvh" and rec["frames"] >= 4
    numbers = run.check_numbers(rec, tiny.plan(CELL))
    assert numbers == dict(state_mismatch=0, pose_gap=0.0, pixel_off_share=0.0,
                           pixel_max_gap=0)
    assert rec["checks"]["last"]["after"].screen.abs().max() > 0


TRACE = segments.trace


def untinted(scene, ori, dirs, ray_ids, frames, anchor, tc, *args, **kwargs):
    """The route with the mirror tint left out."""
    return TRACE(scene, ori, dirs, ray_ids, frames, anchor, dict(tc, mirror_tint=0.0), *args,
                 **kwargs)


def a_place_late(scene, ori, dirs, ray_ids, *args, **kwargs):
    """The route with each ray's draws taken one place further on."""
    return TRACE(scene, ori, dirs, ray_ids + 1, *args, **kwargs)


@pytest.mark.parametrize("perturbed", [untinted, a_place_late])
def test_a_perturbed_route_fails_the_comparison(perturbed, monkeypatch):
    """Ray for ray, and through the benchmark's check of a run."""
    monkeypatch.setattr(segments, "trace", perturbed)
    port, route, _, _ = both(6, 3)
    assert not torch.equal(bits(port), bits(route))
    rec = run_small(2 ** 31 + 12)
    numbers = run.check_numbers(rec, tiny.plan(CELL))
    assert not tiny.correct(rec, CELL, numbers), numbers

