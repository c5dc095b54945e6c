"""The jnp tracer's segment as the shade kernel's plain version, and the
route that walks only the live rays, on the CPU.

- The loop over ``shade_segment_plain`` (render/tracer.py trace_paths on a
  CPU tensor) is bitwise ``parent_trace_paths``, the loop as it was before
  the segment body moved out of it (kept here verbatim), and both follow
  the JAX package's ``trace_paths`` under ``jax.jit`` by the tracer rule,
  on the 4x4 maze, the Cornell box with spheres, a glass sphere with
  ``fresnel`` on and off, a textured box, a seed row and the sky term.
- A plain model of the card's route: each segment walks only the rays
  alive there (gathered in a shuffled order, as the kernel's list holds
  them in no fixed order; the plain walk on them), the dead rays get
  t = BIG, idx = 0 and NaN normal triples, and the light is bitwise the
  all-ray loop's. A dead ray's t and idx feed nothing: garbage there leaves
  every output as it is.
- The kernel wrappers (shade and walk) raise on CPU tensors and on a
  malformed live-id list, with no fallback; the lighting powers are the
  plain version's ``torch.pow``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_tools import as_jax_scene, assert_tracer_rule
from _torch_tools import cornell_scene, parent_trace_paths, textured_cornell
from mirror_maze_tpu.config import TracerConfig as JTracer
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.render.tracer import trace_paths as j_trace_paths
from mirror_maze_tpu_torch.config import EngineConfig, MazeConfig, TracerConfig
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.render import intersect, upload_scene
from mirror_maze_tpu_torch.render.intersect import BIG, nearest_hit_brute
from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn
from mirror_maze_tpu_torch.render.tracer import (
    PathState,
    has_glass,
    lighting_powers,
    path_start,
    seed_row_keys,
    segment_draws,
    shade_segment_kernel,
    shade_segment_plain,
    trace_paths,
)
from mirror_maze_tpu_torch.scene import build_scene

N_RAYS = 3000
LIMITS = dict(bounce_limit=3, mirror_limit=3)
# name -> (scene, tracer settings beyond LIMITS, seed row)
CASES = {
    "maze": ("maze", dict(fresnel=True), False),
    "spheres": ("spheres", dict(fresnel=True), False),
    "glass": ("glass", dict(fresnel=True), False),
    "glass-no-fresnel": ("glass", dict(fresnel=False), False),
    "textured": ("textured", dict(fresnel=True), False),
    "seed_row": ("maze", dict(fresnel=True), True),
    "sky": ("maze", dict(fresnel=True, sky_strength=0.7), False),
}


def _scene(name):
    if name == "maze":
        return build_scene(MazeConfig(width=4, height=4))
    if name == "spheres":
        return cornell_scene("spheres")
    if name == "glass":
        # A mirror sphere and a glass one, in a box with a tall mirror block.
        return dataclasses.replace(cornell_scene("spheres"), sph_ior=np.float32([0.0, 1.5]))
    return textured_cornell("blocks")


def _rays(scene, n, seed=4):
    """Rays from inside the scene's box in random directions, and a seed row."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([scene.origin, scene.origin + scene.u + scene.v])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    o = (mid + rng.uniform(-0.7, 0.7, (n, 3)) * half).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, rng.uniform(0, 1, n).astype(np.float32)


def _case(name):
    scene_name, extra, use_row = CASES[name]
    scene = _scene(scene_name)
    o, d, row = _rays(scene, N_RAYS)
    tracer = dict(LIMITS, **extra)
    return scene, o, d, (row if use_row else None), tracer


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_loop_is_the_parents_and_follows_jax(name):
    """The loop over shade_segment_plain is bitwise the parent's loop, and
    both follow the JAX package's jitted trace_paths by the tracer rule."""
    scene, o, d, row, tracer = _case(name)
    dev = upload_scene(scene, device="cpu")
    jdev = j_upload(as_jax_scene(scene))
    args = (dev.prims, torch.from_numpy(o), torch.from_numpy(d), prng.PRNGKey(11),
            TracerConfig(**tracer))
    seed_row = None if row is None else torch.from_numpy(row)
    got = trace_paths(*args, seed_row=seed_row)
    parent = parent_trace_paths(*args, seed_row=seed_row)
    assert _bitwise(got, parent)
    want = np.asarray(jax.jit(lambda o, d, k, r: j_trace_paths(
        jdev, o, d, k, JTracer(**tracer), seed_row=r))(
        jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(11),
        None if row is None else jnp.asarray(row)))
    assert_tracer_rule(f"trace_paths {name}", want, got.numpy())
    if name == "sky":
        plain = trace_paths(*args[:4], TracerConfig(**dict(tracer, sky_strength=0.0)))
        assert not torch.equal(plain, got)


def _live_route(prims, ori, dirs, key, cfg, nearest, seed_row, seed):
    """The card's route in plain torch: a segment walks only the rays alive
    there, gathered in a shuffled order; the dead rays' t is BIG and idx 0,
    and their normal triples NaN (the card draws the listed rays' alone)."""
    gen = torch.Generator().manual_seed(seed)
    n_rays = ori.shape[0]
    ray_keys = None if seed_row is None else seed_row_keys(key, seed_row)
    st = path_start(ori, dirs)
    walked = []
    for it in range(cfg.max_segments):
        ids = torch.nonzero(st.alive)[:, 0]
        ids = ids[torch.randperm(ids.numel(), generator=gen)]
        walked.append(ids.numel())
        t = torch.full((n_rays,), BIG, dtype=torch.float32)
        idx = torch.zeros((n_rays,), dtype=torch.int32)
        if ids.numel():
            t[ids], idx[ids] = nearest(st.o[ids], st.d[ids])
        g, u3 = segment_draws(key, ray_keys, it, n_rays, has_glass(prims) and cfg.fresnel)
        g = torch.where(st.alive[:, None], g, float("nan"))
        st = shade_segment_plain(prims, cfg, st, t, idx, g, u3, it)
    return st.light, walked


@pytest.mark.parametrize("name", list(CASES))
def test_live_ray_route_is_bitwise_the_all_ray_loop(name):
    """Walking only the live rays (the plain walk on them, bvh backend) gives
    the light of the loop that walks every ray, bit for bit."""
    scene, o, d, row, tracer = _case(name)
    cfg = EngineConfig(maze=MazeConfig(width=4, height=4),
                       tracer=TracerConfig(**tracer)).replace(intersector="bvh")
    dev = upload_scene(scene, device="cpu")
    nearest = scene_nearest_fn(dev, cfg)
    ori, dirs = torch.from_numpy(o), torch.from_numpy(d)
    seed_row = None if row is None else torch.from_numpy(row)
    want = trace_paths(dev.prims, ori, dirs, prng.PRNGKey(11), cfg.tracer, nearest,
                       seed_row=seed_row)
    got, walked = _live_route(dev.prims, ori, dirs, prng.PRNGKey(11), cfg.tracer, nearest,
                              seed_row, seed=len(name))
    print(f"{name}: live rays a segment {walked}")
    assert _bitwise(got, want)
    assert walked[0] == N_RAYS and walked[-1] < N_RAYS // 2


@pytest.mark.parametrize("name", ["maze", "glass", "textured"])
def test_dead_rays_t_and_idx_feed_nothing(name):
    """A segment with garbage t and idx on its dead rays (ids in range, any
    distance) gives the same state as with BIG and 0 there, and leaves the
    dead rays' state as it was: what lets the kernel skip them."""
    scene, o, d, row, tracer = _case(name)
    cfg = TracerConfig(**tracer)
    prims = upload_scene(scene, device="cpu").prims
    fresnel = has_glass(prims) and cfg.fresnel
    st = path_start(torch.from_numpy(o), torch.from_numpy(d))
    it = 0
    while bool(st.alive.all()):     # to the first segment that starts with dead rays
        t, idx = nearest_hit_brute(prims, st.o, st.d, cfg.t_min)
        g, u3 = segment_draws(prng.PRNGKey(3), None, it, N_RAYS, fresnel)
        st = shade_segment_plain(prims, cfg, st, t, idx, g, u3, it)
        it += 1
    dead = ~st.alive
    assert 0 < int(dead.sum()) < N_RAYS and it < cfg.max_segments
    t, idx = nearest_hit_brute(prims, st.o, st.d, cfg.t_min)
    g, u3 = segment_draws(prng.PRNGKey(3), None, it, N_RAYS, fresnel)
    clean = shade_segment_plain(prims, cfg, st, torch.where(dead, BIG, t),
                                torch.where(dead, 0, idx), g, u3, it)
    gen = torch.Generator().manual_seed(5)
    n_prims = prims.num_planes + prims.num_spheres
    junk_t = torch.where(dead, torch.rand(N_RAYS, generator=gen) * 10.0, t)
    junk_i = torch.where(dead, torch.randint(0, n_prims, (N_RAYS,), generator=gen,
                                             dtype=torch.int32), idx)
    dirty = shade_segment_plain(prims, cfg, st, junk_t, junk_i, g, u3, it)
    for f in PathState._fields:
        a, b, before = getattr(clean, f), getattr(dirty, f), getattr(st, f)
        assert _bitwise(a, b), f
        assert _bitwise(a[dead], before[dead]), f


def _cpu_segment():
    scene, o, d, _, tracer = _case("maze")
    cfg = TracerConfig(**tracer)
    prims = upload_scene(scene, device="cpu").prims
    st = path_start(torch.from_numpy(o), torch.from_numpy(d))
    t, idx = nearest_hit_brute(prims, st.o, st.d, cfg.t_min)
    g, _ = segment_draws(prng.PRNGKey(3), None, 0, N_RAYS, False)
    return prims, cfg, st, t, idx, g


def _list(kind):
    ids, count = torch.zeros(N_RAYS, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    return {"good": (ids, count), "short ids": (ids[:-1], count),
            "int64 ids": (ids.long(), count), "two counts": (ids, torch.zeros(2, dtype=torch.int32)),
            "float count": (ids, count.float()), "strided ids": (
                torch.zeros(2 * N_RAYS, dtype=torch.int32)[::2], count)}[kind]


@pytest.mark.parametrize("kind", ["good", "short ids", "int64 ids", "two counts", "float count",
                                  "strided ids"])
def test_shade_wrapper_raises_on_cpu_tensors_and_bad_lists(kind):
    """The shade kernel's wrapper takes no CPU tensor (the plain version is
    shade_segment_plain) and no malformed live-id list; it never falls
    back."""
    prims, cfg, st, t, idx, g = _cpu_segment()
    match = "CUDA tensors" if kind == "good" else "live-id list"
    with pytest.raises(ValueError, match=match):
        shade_segment_kernel(prims, cfg, st, t, idx, g, None, 0, live_out=_list(kind))
    if kind == "good":
        with pytest.raises(ValueError, match="CUDA tensors"):
            shade_segment_kernel(prims, cfg, st, t, idx, g, None, 0)


@pytest.mark.parametrize("kind", ["good", "short ids", "int64 ids", "two counts", "float count",
                                  "strided ids"])
def test_walk_wrapper_raises_on_cpu_tensors_and_bad_lists(kind):
    """The walk kernel's wrapper takes a live-id list of the rays' length
    and raises on CPU tensors, with a list or without."""
    scene, o, d, _, _ = _case("maze")
    p = upload_scene(scene, device="cpu").prims
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    match = "CUDA tensors" if kind == "good" else "live-id list"
    with pytest.raises(ValueError, match=match):
        intersect.nearest_hit_bvh_kernel(p, o, d, 0.1, 8, 2, live=_list(kind))
    if kind == "good":
        with pytest.raises(ValueError, match="CUDA tensors"):
            intersect.nearest_hit_bvh_kernel(p, o, d, 0.1, 8, 2)


def test_trace_paths_raises_off_cpu_and_cuda():
    """trace_paths shades on the card or on the CPU, nowhere else."""
    scene, o, d, _, tracer = _case("maze")
    prims = upload_scene(scene, device="cpu").prims
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        trace_paths(prims, meta, meta, prng.PRNGKey(0), TracerConfig(**tracer))


@pytest.mark.parametrize("factor", [0.25, 0.0, 0.7])
def test_lighting_powers_are_the_plain_versions_pow(factor):
    """The kernel's table of lighting_factor^k is the plain version's
    torch.pow of the same exponents, bit for bit, and is made once."""
    cfg = TracerConfig(lighting_factor=factor, **LIMITS)
    table = lighting_powers(factor, cfg.max_segments + 1, "cpu")
    assert table is lighting_powers(factor, cfg.max_segments + 1, "cpu")
    for it in range(cfg.max_segments):
        mh = torch.arange(it + 1, dtype=torch.int32)
        want = torch.pow(cfg.lighting_factor, (it - mh).to(torch.float32))
        assert _bitwise(table[(it - mh).long()], want)
