"""Shared helpers of the PyTorch/CUDA port's tests (tests/test_torch_*.py).

The port's tests run the same inputs, made with NumPy from a fixed seed,
through the JAX package and through the port on the CPU, and compare.
Tests of the CUDA kernels themselves are in tests/test_torch_cuda.py, which
imports no JAX so that it also runs on the GPU machine (with
``--noconftest``); they skip on a machine without a card.

This module imports no JAX either: ``chip_smoke.py`` takes the golden
configuration and script, and the gallery scenes (the Cornell box, the mesh
gallery), from here, so the card's runs and the CPU tests cannot drift
apart.
"""

import dataclasses

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

import mirror_maze_tpu_torch as P
from mirror_maze_tpu_torch.examples import cornell_box, mesh_gallery
from mirror_maze_tpu_torch.scene import build_scene, mesh
from mirror_maze_tpu_torch.scene.builder import Scene


def golden_config() -> "P.EngineConfig":
    """The port's counterpart of tests/_golden_tools.py golden_cfg("pallas")
    (test_torch_engine.py holds the two equal)."""
    return P.EngineConfig(
        maze=P.MazeConfig(width=4, height=4, seed=0),
        tracer=P.TracerConfig(bounce_limit=3, mirror_limit=3),
        camera=P.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=P.ScreenConfig(width=64, height=48, samples_per_pixel=8),
        intersector="pallas",
    )


def golden_script(fi) -> list:
    """The 28-frame golden script of tests/_golden_tools.py run_golden_script
    (idle, walk, turn, idle), built from the FrameInputs class ``fi`` of
    either package."""
    return ([fi.idle()] * 8 + [fi.make(w=True)] * 8
            + [fi.make(mouse_dx=16.0)] * 4 + [fi.idle()] * 8)


def multi_tile_config(pkg, width=64, height=48):
    """A small configuration on the multi-tile path: a 16x16 maze (its
    walls fill two tiles of 128), ``noise_rng`` on and the chunk window
    Morton-sorted, 2 spp. ``pkg`` holds the config classes: the port's
    package or the JAX package's ``config`` module."""
    return pkg.EngineConfig(
        maze=pkg.MazeConfig(width=16, height=16),
        tracer=pkg.TracerConfig(bounce_limit=3, mirror_limit=4, noise_rng=True, block_rows=1),
        screen=pkg.ScreenConfig(width=width, height=height, samples_per_pixel=2,
                                sort_chunk_window=True),
        intersector="pallas",
    )


def multi_tile_script(fi) -> list:
    """12 frames for ``multi_tile_config``: idle, walk, turn, idle."""
    return ([fi.idle()] * 4 + [fi.make(w=True)] * 4
            + [fi.make(mouse_dx=16.0)] * 2 + [fi.idle()] * 2)


def glass_maze_config(pkg, width=64, height=48):
    """A small configuration on the glass path: a 6x6 maze with
    ``glass_prob`` 0.5 (two interior mirror walls become glass panes, the
    kernel's mode 6), ``fresnel`` on, 2 spp."""
    return pkg.EngineConfig(
        maze=pkg.MazeConfig(width=6, height=6, glass_prob=0.5),
        tracer=pkg.TracerConfig(bounce_limit=3, mirror_limit=4, block_rows=1),
        screen=pkg.ScreenConfig(width=width, height=height, samples_per_pixel=2),
        intersector="pallas",
    )


def soup_arrays() -> dict:
    """The 150-quad random soup of tests/test_pallas_tracer.py
    test_random_multitile_scene_matches_exactly, as the fields of either
    package's ``Scene``: skewed diffuse quads, an open scene, two tiles."""
    r = np.random.default_rng(11)
    n = 150
    origin = r.uniform(-20, 20, (n, 3))
    v = r.normal(size=(n, 3)) * 2.0
    u = r.normal(size=(n, 3)) * 2.0
    em = np.concatenate(
        [r.uniform(0, 1, (n, 3)), (r.random((n, 1)) < 0.3) * r.uniform(0, 2, (n, 1))], axis=1)
    return dict(
        origin=origin.astype(np.float32), v=v.astype(np.float32), u=u.astype(np.float32),
        color=r.uniform(0, 1, (n, 3)).astype(np.float32), is_mirror=np.zeros(n, bool),
        emission=em.astype(np.float32), grid=np.zeros((1, 1), np.uint8))


def _quad_scene(rows) -> Scene:
    """A Scene of quads from (origin, v, u, color, is_mirror, emission) rows."""
    o, v, u, c, m, e = zip(*rows)
    return Scene(origin=np.asarray(o, np.float32), v=np.asarray(v, np.float32),
                 u=np.asarray(u, np.float32), color=np.asarray(c, np.float32),
                 is_mirror=np.asarray(m, bool), emission=np.asarray(e, np.float32),
                 grid=np.zeros((1, 1), np.uint8))


GALLERY_SPAWN = cornell_box.SPAWN           # the examples' camera
CORNELL_GLASS_CENTRE = (1.6, 2.0 - 1.8, -2.2)


def cornell_scene(variant: str) -> Scene:
    """The Cornell box of the port's examples/cornell_box.py (the JAX
    example's scene, array for array: test_torch_examples.py), variant
    ``blocks`` (a short diffuse and a tall mirror block, 17 quads),
    ``spheres`` (a mirror and a diffuse sphere: test mode 3) or ``glass`` (a
    glass sphere beside a tall mirror block: mode 5)."""
    return cornell_box.build_cornell_box(variant)


def checker_floor(scene: Scene, cells: float = 8.0, color2=(0.25, 0.25, 0.3)) -> Scene:
    """The scene with its floor (plane 0) a UV checker, ``tex_kind`` 1
    (the port's examples/cornell_box.py checker_floor)."""
    return cornell_box.checker_floor(scene, cells, color2)


def textured_cornell(variant: str) -> Scene:
    """The Cornell box with every texture case: the checker floor (kind 1),
    the left wall a world checker (kind 2) and, in the ``spheres`` variant,
    the diffuse sphere a world checker too. The wall stands at x = -5 and its
    cells are 1.3 wide, so the wall lies inside a cell (-5 / 1.3 = -3.85) and
    not on a cell edge, where an ulp of the hit point would pick the cell."""
    scene = checker_floor(cornell_scene(variant))
    kind, scale = scene.tex_kind.copy(), scene.tex_scale.copy()
    color = scene.tex_color2.copy()
    kind[4], scale[4], color[4] = 2, 1.3, (0.9, 0.8, 0.2)
    scene = dataclasses.replace(scene, tex_kind=kind, tex_scale=scale, tex_color2=color)
    if variant == "spheres":
        scene = dataclasses.replace(
            scene, sph_tex_kind=np.uint8([0, 2]), sph_tex_scale=np.float32([1.0, 0.6]),
            sph_tex_color2=np.float32([(0, 0, 0), (0.1, 0.2, 0.7)]))
    return scene


def tied_floor_scene():
    """The checker-floor box plus an untextured copy of the floor quad: the
    two tie exactly wherever the floor is hit."""
    box = checker_floor(cornell_scene("blocks"))
    floor = dataclasses.replace(
        box, **{f: np.asarray(getattr(box, f))[:1] for f in
                ("origin", "v", "u", "color", "is_mirror", "emission", "kind", "ior")},
        tex_kind=np.zeros(1, np.uint8), tex_scale=np.ones(1, np.float32),
        tex_color2=np.zeros((1, 3), np.float32))
    return mesh.merge_scenes(box, floor)


def textured_maze_scene():
    """An 8x8 maze with spheres; half of the planes and spheres textured at
    random (planes kind 1 or 2, spheres kind 2)."""
    scene = scene_subset(primitive_zoo(8), {3})
    r = np.random.default_rng(2)
    n, s = scene.num_planes, scene.num_spheres
    return dataclasses.replace(
        scene,
        tex_kind=(r.integers(1, 3, n) * (r.random(n) < 0.5)).astype(np.uint8),
        tex_scale=r.uniform(0.3, 4.0, n).astype(np.float32),
        tex_color2=r.uniform(0, 1, (n, 3)).astype(np.float32),
        sph_tex_kind=(2 * (r.random(s) < 0.5)).astype(np.uint8),
        sph_tex_scale=r.uniform(0.3, 2.0, s).astype(np.float32),
        sph_tex_color2=r.uniform(0, 1, (s, 3)).astype(np.float32))


def mesh_gallery_scene() -> Scene:
    """The mesh gallery of the port's examples/mesh_gallery.py: a room of 7
    quads, a 320-triangle mirror icosphere and two 20-triangle gems (the
    second through an OBJ file)."""
    return mesh_gallery.build_mesh_gallery()


def gallery_config(size: int, spp: int, aperture: float = 0.0, focus_dist: float = 10.0):
    """The examples' render configuration: the camera at GALLERY_SPAWN looking
    along +z, a square frame, the fused tracer."""
    return P.EngineConfig(
        camera=P.CameraConfig(spawn=GALLERY_SPAWN, look_dir=(0, 0, 1), aperture=aperture,
                              focus_dist=focus_dist),
        screen=P.ScreenConfig(width=size, height=size, samples_per_pixel=spp),
        intersector="pallas",
    )


def primitive_zoo(maze_width: int = 8, seed: int = 0) -> Scene:
    """A small scene with every test mode: a maze (``glass_prob`` 0.5: modes
    0, 1, 2 and the odd pane of 6), ten free-standing skewed glass panes
    (6), a dozen spheres of which four are glass (3, 5), an opaque
    icosphere of 80 triangles and a glass icosahedron (4, 7), all inside
    the maze's extent. Made from ``seed`` with NumPy, so both packages can
    build the same one."""
    r = np.random.default_rng(seed)
    maze = build_scene(P.MazeConfig(width=maze_width, height=maze_width, glass_prob=0.5))
    ext = 5.0 * maze_width - 3.0
    panes = dataclasses.replace(
        _quad_scene([(np.array([x, 2.0, z]), (r.normal(0, 0.3), -r.uniform(4, 9), r.normal(0, 0.3)),
                      (r.uniform(-4, 4), 0.0, r.uniform(-4, 4)), (0.9, 1.0, 0.95), False,
                      (0, 0, 0, 0))
                     for x, z in r.uniform(-ext, ext, (10, 2))]),
        ior=np.full(10, 1.5, np.float32))
    n = 12
    centre = np.stack([r.uniform(-ext, ext, n), r.uniform(-5.0, 0.0, n),
                       r.uniform(-ext, ext, n)], axis=1)
    em = np.concatenate([r.uniform(0, 1, (n, 3)), (r.random((n, 1)) < 0.4) * 1.5], axis=1)
    spheres = dataclasses.replace(
        _quad_scene([((0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), False, (0, 0, 0, 0))]),
        sph_center=centre.astype(np.float32),
        sph_radius=r.uniform(0.8, 2.5, n).astype(np.float32),
        sph_color=r.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
        sph_is_mirror=r.random(n) < 0.3,
        sph_emission=em.astype(np.float32),
        sph_ior=np.where(np.arange(n) % 3 == 0, 1.5, 0.0).astype(np.float32),
    )
    bv, bf = mesh.icosphere(subdivisions=1, radius=2.5, center=(ext * 0.4, -2.0, -ext * 0.3))
    ball = mesh.mesh_scene(bv, bf, color=(0.8, 0.7, 0.3), emission=(1.0, 0.8, 0.4, 0.3))
    gv, gf = mesh.icosphere(subdivisions=0, radius=2.0, center=(-ext * 0.5, -1.5, ext * 0.2))
    gem = mesh.mesh_scene(gv, gf, color=(0.9, 0.95, 1.0), ior=1.4)
    return mesh.merge_scenes(maze, panes, spheres, ball, gem)


PLANE_FIELDS = ("origin", "v", "u", "color", "is_mirror", "emission", "kind", "ior",
                "tex_kind", "tex_scale", "tex_color2")
SPHERE_FIELDS = ("sph_center", "sph_radius", "sph_color", "sph_is_mirror", "sph_emission",
                 "sph_ior", "sph_tex_kind", "sph_tex_scale", "sph_tex_color2")


def scene_subset(scene, modes):
    """The scene without the primitives of the modes 3-7 not in ``modes``."""
    kind, glass = np.asarray(scene.kind), np.asarray(scene.ior) > 0
    mode = np.where(glass, np.where(kind == 3, 7, 6), np.where(kind == 3, 4, kind))
    keep = (mode < 3) | np.isin(mode, list(modes))
    sph_mode = np.where(np.asarray(scene.sph_ior) > 0, 5, 3)
    sph_keep = np.isin(sph_mode, list(modes))
    return dataclasses.replace(
        scene, **{f: np.asarray(getattr(scene, f))[keep] for f in PLANE_FIELDS},
        **{f: np.asarray(getattr(scene, f))[sph_keep] for f in SPHERE_FIELDS})


def aimed_rays(scene, n, seed, extent):
    """Random rays inside the world; every second one aims at a primitive
    that is not part of the maze (a sphere, a triangle, a pane)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-7, 1, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    extra = (np.asarray(scene.kind) == 3) | (np.asarray(scene.ior) > 0)
    targets = np.concatenate([
        (np.asarray(scene.origin) + 0.4 * (np.asarray(scene.u) + np.asarray(scene.v)))[extra],
        np.asarray(scene.sph_center)]).astype(np.float32)
    if len(targets):
        aim = targets[rng.integers(0, len(targets), n)] + rng.normal(0, 0.3, (n, 3))
        d[::2] = (aim - o)[::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def giant_leaf_scene() -> Scene:
    """Seven coincident quads, which the SAH builder keeps in one BVH leaf
    (the giant leaf of tests/test_intersect.py)."""
    n = 7
    return Scene(
        origin=np.tile(np.float32([[-0.5, -0.5, 0.0]]), (n, 1)),
        v=np.tile(np.float32([[1.0, 0.0, 0.0]]), (n, 1)),
        u=np.tile(np.float32([[0.0, 1.0, 0.0]]), (n, 1)),
        color=np.ones((n, 3), np.float32), is_mirror=np.zeros(n, bool),
        emission=np.zeros((n, 4), np.float32), grid=np.zeros((1, 1), np.uint8))


# The scenes of the intersector tests: a 4x4 maze, the Cornell box with an
# opaque mirror sphere and a glass sphere, the mesh gallery (360 triangles),
# and the giant leaf.
INTERSECT_SCENES = ("maze", "spheres", "mesh", "leaf")


def intersect_scene(name: str) -> Scene:
    """One of ``INTERSECT_SCENES``."""
    if name == "maze":
        return build_scene(P.MazeConfig(width=4, height=4))
    if name == "spheres":
        return dataclasses.replace(cornell_scene("spheres"), sph_ior=np.float32([0.0, 1.5]))
    if name == "mesh":
        return mesh_gallery_scene()
    return giant_leaf_scene()


def scene_rays(scene: Scene, n: int, seed: int):
    """Rays from points inside the scene's box, in random directions; the
    giant leaf's come from in front of the quads, towards them."""
    rng = np.random.default_rng(seed)
    if scene.num_planes == 7:
        o = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
        o[:, 2] = -3.0
        d = np.float32([0, 0, 1]) + rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    else:
        pts = np.concatenate([scene.origin, scene.origin + scene.u + scene.v])
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        mid, half = (lo + hi) / 2, (hi - lo) / 2
        o = (mid + rng.uniform(-0.8, 0.8, (n, 3)) * half).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def zero_component_rays(scene: Scene, n: int, seed: int):
    """``scene_rays`` with exact zeros in the directions: every ray has one
    zero component, every third two (it runs along an axis), and the origin
    lies on a face plane of a BVH node's box on each zero axis, so the slab
    test meets (bmin - o) * (1 / 0) = 0 * inf = NaN there."""
    from mirror_maze_tpu_torch.scene.bvh import build_bvh

    rng = np.random.default_rng(seed)
    o, d = scene_rays(scene, n, seed)
    bvh = build_bvh(scene.origin, scene.u, scene.v)
    faces = np.stack([bvh.aabb_min, bvh.aabb_max], axis=1)      # [M, 2, 3]
    for i in range(n):
        axes = rng.permutation(3)[:1 + (i % 3 == 0)]
        for a in axes:
            d[i, a] = 0.0
            o[i, a] = faces[rng.integers(len(faces)), rng.integers(2), a]
        if not d[i].any():
            d[i, (axes[0] + 1) % 3] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def gif_frame_count(path: str) -> int:
    """The images of a GIF file, counted by walking its blocks (no
    decoding): the machine with the card may lack PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path} is not a GIF")

    def table_end(pos, flags):
        return pos + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)

    def sub_blocks_end(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    pos, count = table_end(13, data[10]), 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:                   # extension: label, sub-blocks
            pos = sub_blocks_end(pos + 2)
        elif data[pos] == 0x2C:                 # image: descriptor, table, LZW
            count += 1
            pos = sub_blocks_end(table_end(pos + 10, data[pos + 9]) + 1)
        else:
            raise ValueError(f"{path}: no GIF block at byte {pos}")
    return count


def port_config(cfg) -> "P.EngineConfig":
    """The port's EngineConfig equal field for field to a JAX package one."""
    return P.EngineConfig(
        maze=P.MazeConfig(**dataclasses.asdict(cfg.maze)),
        tracer=P.TracerConfig(**dataclasses.asdict(cfg.tracer)),
        camera=P.CameraConfig(**dataclasses.asdict(cfg.camera)),
        screen=P.ScreenConfig(**dataclasses.asdict(cfg.screen)),
        intersector=cfg.intersector,
    )


def assert_frames_match(got: np.ndarray, ref: np.ndarray) -> None:
    """The golden rule of tests/test_golden.py: uint8 frames with >= 99.9%
    of pixels within 1 LSB and no pixel off by more than 4."""
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert (diff <= 1).mean() > 0.999, f"{(diff <= 1).mean():.5f} within 1 LSB"
    assert diff.max() <= 4, f"max diff {diff.max()}"


def compare_states(jst, st) -> None:
    """A JAX package EngineState against the port's: the queue, cursor, key
    and frame counter bitwise, the camera within atol=1e-6."""
    for f in ("perm", "cursor", "key", "frame"):
        np.testing.assert_array_equal(
            getattr(st, f).cpu().numpy().astype(np.int64),
            np.asarray(getattr(jst, f)).astype(np.int64), err_msg=f)
    for f in ("cam_center", "quat", "half_theta"):
        np.testing.assert_allclose(getattr(st, f).cpu().numpy(), np.asarray(getattr(jst, f)),
                                   rtol=0, atol=1e-6, err_msg=f)


class NoHostReads(TorchFunctionMode):
    """Raises on what a CUDA graph capture forbids: reading a tensor on the
    host, and copying host data into a tensor."""

    FORBIDDEN = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__int__,
                 torch.Tensor.__float__, torch.Tensor.__index__, torch.Tensor.tolist,
                 torch.Tensor.cpu, torch.Tensor.numpy, torch.tensor, torch.as_tensor,
                 torch.from_numpy}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.FORBIDDEN:
            raise AssertionError(f"host read or host copy in the step body: {func.__name__}")
        return func(*args, **(kwargs or {}))


def eager_multiplayer_step(cfg, dev, slots, others, bounds):
    """A player's step as it ran before the multiplayer graph, given the
    gathered positions: ``update_avatars`` (the avatars at ``slots`` to the
    positions of the players ``others``), ``make_sphere_refresh`` for the
    fused kernel, then ``make_step_fn`` (eager on every device) with the bvh
    ``bounds``. ``step(state, inputs, positions [P, 3]) -> (state, frame)``."""
    from mirror_maze_tpu_torch.parallel.multiplayer import update_avatars
    from mirror_maze_tpu_torch.render.scenebuf import make_sphere_refresh
    from mirror_maze_tpu_torch.runtime.step import make_step_fn

    base = make_step_fn(cfg, *bounds)
    refresh = make_sphere_refresh(dev) if cfg.intersector == "pallas" and slots else None
    others = list(others)

    def step(state, inputs, positions):
        scene = dev
        if slots:
            scene = update_avatars(scene, slots, positions[others])
        if refresh is not None:
            scene = refresh(scene)
        return base(scene, state, inputs)

    return step


# The jnp tracer's segment (render/tracer.py): the loop as it was before its
# body became shade_segment_plain, and the shade kernel held against that
# plain version segment by segment.


def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def parent_trace_paths(prims, ori, dirs, key, cfg, nearest_fn=None, seed_row=None):
    """render/tracer.py trace_paths as it was before its segment body became
    shade_segment_plain (every ray walked and shaded in torch ops each
    segment), kept verbatim: the reference of the CPU loop and, on the card,
    of the kernel route."""
    from mirror_maze_tpu_torch.device import constant
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.ops.sampling import unit_sphere
    from mirror_maze_tpu_torch.ops.vecmath import dot, normalize, reflect, sqrt
    from mirror_maze_tpu_torch.render.intersect import BIG, nearest_hit_brute

    if nearest_fn is None:
        nearest_fn = lambda o, d: nearest_hit_brute(prims, o, d, cfg.t_min)  # noqa: E731
    n_rays = ori.shape[0]
    dev = ori.device
    sky = constant(tuple(cfg.sky_color), torch.float32, dev)
    ray_keys = None
    if seed_row is not None:
        seed_ints = (seed_row * float(1 << 24)).to(torch.int32)
        idx_ints = torch.arange(n_rays, dtype=torch.int32, device=dev)
        ray_keys = prng.fold_in(prng.fold_in(key, idx_ints), seed_ints)

    n_planes, n_sph = prims.num_planes, prims.num_spheres
    if n_sph:
        albedo_all = torch.cat([prims.color, prims.sph_color])
        em_all = torch.cat([prims.emission, prims.sph_emission])
        mir_all = torch.cat([prims.is_mirror, prims.sph_is_mirror])
    has_tex = prims.tex is not None
    if has_tex:
        tex_all = torch.cat([prims.tex, prims.sph_tex]) if n_sph else prims.tex
    has_glass = prims.ior is not None or prims.sph_ior is not None
    if has_glass:
        ior_p = prims.ior if prims.ior is not None else torch.zeros(
            n_planes, dtype=torch.float32, device=dev)
        ior_all = ior_p
        if n_sph:
            ior_s = prims.sph_ior if prims.sph_ior is not None else torch.zeros(
                n_sph, dtype=torch.float32, device=dev)
            ior_all = torch.cat([ior_p, ior_s])

    o, d = ori, dirs
    thr = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    light = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    mh = torch.zeros((n_rays,), dtype=torch.int32, device=dev)
    dc = torch.zeros((n_rays,), dtype=torch.int32, device=dev)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=dev)
    for it in range(cfg.max_segments):
        t, idx = nearest_fn(o, d)
        hit = alive & (t < BIG)
        ix = idx.long()
        if n_sph:
            albedo, em, mir = albedo_all[ix], em_all[ix], mir_all[ix]
            si = ix - n_planes
            is_s = si >= 0
            sc = prims.sph_center[si.clamp(0, n_sph - 1)]
            inv_r = prims.sph_inv_r[si.clamp(0, n_sph - 1)]
            hit_p = o + d * t[:, None]
            n = torch.where(is_s[:, None], (hit_p - sc) * inv_r[:, None],
                            prims.normal[ix.clamp(max=n_planes - 1)])
        else:
            n, albedo = prims.normal[ix], prims.color[ix]
            em, mir = prims.emission[ix], prims.is_mirror[ix]
        if has_tex:
            tx = tex_all[ix]
            tk, tsc, c2 = tx[:, 0], tx[:, 1], tx[:, 2:5]
            hit_t = o + d * t[:, None]
            pidx = ix.clamp(max=n_planes - 1)
            s1t = dot(hit_t, prims.w1[pidx]) - prims.b1[pidx]
            s2t = dot(hit_t, prims.w2[pidx]) - prims.b2[pidx]
            f1 = torch.floor(s1t * tsc) + torch.floor(s2t * tsc)
            f2 = ((torch.floor(hit_t[:, 0] / tsc) + torch.floor(hit_t[:, 1] / tsc))
                  + torch.floor(hit_t[:, 2] / tsc))
            f = torch.where(tk > 1.5, f2, f1)
            odd = (f - 2.0 * torch.floor(f * 0.5)) > 0.5
            albedo = torch.where(((tk > 0.0) & odd)[:, None], c2, albedo)

        side = -torch.sign(dot(d, n))
        diffuse = hit & (~mir | (side == -1.0))
        mirror = hit & mir & (side != -1.0)
        if has_glass:
            glass = hit & (ior_all[ix] > 0.0)
            diffuse = diffuse & ~glass
            mirror = mirror & ~glass
            spec = mirror | glass
        else:
            spec = mirror
        mh_new = mh + spec.to(torch.int32)
        mirror_live = mirror & (mh_new < cfg.mirror_limit)
        advance = diffuse | mirror_live
        if has_glass:
            glass_live = glass & (mh_new < cfg.mirror_limit)
            advance = advance | glass_live

        if ray_keys is None:
            rnd = unit_sphere(prng.fold_in(key, it), (n_rays,))
        else:
            it_keys = prng.fold_in(ray_keys, it)
            rnd = unit_sphere(it_keys, ())
        scat = normalize(rnd + n * side[:, None])
        light = torch.where(diffuse[:, None], light + em[:, :3] * em[:, 3:4] * thr, light)
        thr = torch.where(diffuse[:, None], thr * albedo, thr)

        light = torch.where(mirror_live[:, None], light + albedo * cfg.mirror_tint, light)
        refl = normalize(reflect(d, n))

        if has_glass:
            ior_r = ior_all[ix]
            dhat = normalize(d)
            n_eff = n * side[:, None]
            cos_i = torch.clamp(-dot(dhat, n_eff), 0.0, 1.0)
            eta = torch.where(side > 0.0, 1.0 / torch.clamp_min(ior_r, 1e-6), ior_r)
            sin2t = eta * eta * (1.0 - cos_i * cos_i)
            tir = sin2t > 1.0
            if cfg.fresnel:
                q = (1.0 - eta) / (1.0 + eta)
                r0 = q * q
                reflect_p = torch.where(tir, 1.0, r0 + (1.0 - r0) * _pow5(1.0 - cos_i))
                if ray_keys is None:
                    u3 = prng.uniform(prng.fold_in(prng.fold_in(key, it), 1), (n_rays,))
                else:
                    u3 = prng.uniform(prng.fold_in(it_keys, 1), ())
                do_refl = u3 < reflect_p
            else:
                do_refl = tir
            refr = (eta[:, None] * dhat
                    + (eta * cos_i - sqrt(torch.clamp_min(1.0 - sin2t, 0.0)))[:, None]
                    * n_eff)
            gdir = normalize(torch.where(do_refl[:, None], reflect(dhat, n), refr))
            thr = torch.where(glass_live[:, None], thr * albedo, thr)

        miss = alive & ~hit
        fall = torch.pow(cfg.lighting_factor, (it - mh).to(torch.float32))
        sky_term = sky * fall[:, None] * cfg.sky_strength
        light = torch.where(miss[:, None], light + sky_term, light)

        o = torch.where(advance[:, None], o + d * t[:, None], o)
        d = torch.where(diffuse[:, None], scat, torch.where(mirror_live[:, None], refl, d))
        if has_glass:
            d = torch.where(glass_live[:, None], gdir, d)
        dc = dc + diffuse.to(torch.int32)
        mh = mh_new
        alive = (alive & ~miss & ~(spec & (mh_new >= cfg.mirror_limit))
                 & (dc < cfg.bounce_limit))
    return light


def bits(x: torch.Tensor) -> torch.Tensor:
    """x as comparable bits: float32 viewed as int32, anything else as is."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def shade_segments(prims, cfg, ori, dirs, key, nearest_fn, seed_row=None, before=None):
    """The bounce loop on the card with the shade kernel, each segment also
    through ``shade_segment_plain`` on the same inputs (the nearest hits of
    every ray, ``nearest_fn(o, d)``; the segment's draws): per segment a dict
    of the rays alive before and after, the kernel's live count, the rays
    whose ``PathState`` fields differ from the plain version's (by field),
    and whether the kernel's live-id list holds exactly the live rays.
    ``before(it, state, t, idx, g, u3)`` is called ahead of each launch
    (which then updates the state in place). Returns (records, state)."""
    from mirror_maze_tpu_torch.render.tracer import (
        PathState,
        has_glass,
        path_start,
        seed_row_keys,
        segment_draws,
        shade_segment_kernel,
        shade_segment_plain,
    )

    n_rays, dev = ori.shape[0], ori.device
    ray_keys = None if seed_row is None else seed_row_keys(key, seed_row)
    fresnel = has_glass(prims) and cfg.fresnel
    st = path_start(ori, dirs)
    ids = torch.empty((n_rays,), dtype=torch.int32, device=dev)
    records = []
    for it in range(cfg.max_segments):
        t, idx = nearest_fn(st.o, st.d)
        g, u3 = segment_draws(key, ray_keys, it, n_rays, fresnel)
        want = shade_segment_plain(prims, cfg, st, t, idx, g, u3, it)
        live_in = int(st.alive.sum())
        if before is not None:
            before(it, st, t, idx, g, u3)
        count = torch.zeros((1,), dtype=torch.int32, device=dev)
        st = shade_segment_kernel(prims, cfg, st, t, idx, g, u3, it, live_out=(ids, count))
        n_live = int(count)
        listed = torch.sort(ids[:min(n_live, n_rays)]).values
        diff = {f: int((bits(getattr(st, f)) != bits(getattr(want, f))).reshape(n_rays, -1)
                       .any(dim=1).sum()) for f in PathState._fields}
        records.append(dict(segment=it, live_in=live_in, live_out=int(want.alive.sum()),
                            count=n_live, diff={f: v for f, v in diff.items() if v},
                            ids=torch.equal(listed, torch.nonzero(want.alive)[:, 0].int())))
    return records, st


def shade_records_ok(records) -> bool:
    """Every segment bitwise the plain version, its live count and list
    right."""
    return all(not r["diff"] and r["count"] == r["live_out"] and r["ids"] for r in records)


def segment_lists(prims, ori, dirs, key, cfg, nearest_fn, seed_row=None):
    """The card's segment loop (render/tracer.py trace_paths) on ``ori``,
    ``dirs``: (its light, {segment it: a copy of the live-id list (ids,
    count) that segment's walk and normal draw read}) for it >= 1, recorded
    at the walk's call."""
    from mirror_maze_tpu_torch.render.tracer import trace_paths

    lists = {}

    def recording(o, d, live=None):
        if live is None:
            return nearest_fn(o, d)
        lists[len(lists) + 1] = tuple(x.clone() for x in live)
        return nearest_fn(o, d, live=live)

    light = trace_paths(prims, ori, dirs, key, cfg, recording, seed_row)
    return light, lists


def listed_normal(key, shape, rows, canary: int):
    """``prng.normal(key, shape, rows=rows)``'s launch (ops/prng.py
    ``listed``, C entry ``mm_threefry_rows``) into an output pre-filled with
    the int32 pattern ``canary``, which the rows off the list keep."""
    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.ops import prng

    d = prng.listed(prng.bits_draw(key, shape, prng._NORMAL), rows)
    out = torch.full(d.shape, canary, dtype=torch.int32, device=key.device).view(torch.float32)
    if d.total:
        keys = d.keys.contiguous()
        with torch.cuda.device(key.device):
            kernels.launch("threefry", keys.data_ptr(), d.key_stride, d.source, d.output, None,
                           d.data_stride, d.data_imm, d.per_key, d.total, d.lo, d.hi,
                           out.data_ptr(), d.ids.data_ptr(), d.count.data_ptr(),
                           symbol="mm_threefry_rows", count_as="canary")
    return out


def edge_segment(prims, n_rays: int, device):
    """A segment's inputs whose dots meet torch.sign's and torch.clamp's
    edges, beside random rays: (state, t, idx, g) with every ray alive and a
    hit on plane 0 (axis-aligned) at t = 1, the directions along plane 0
    (d.n = +0), along it with every product -0 (d.n = -0), NaN, and random;
    g random normals."""
    from mirror_maze_tpu_torch.render.tracer import path_start

    gen = torch.Generator().manual_seed(13)
    normal = prims.normal[0].cpu()
    axis = int(normal.abs().argmax())
    if float(normal.abs().max()) != 1.0 or int((normal != 0).sum()) != 1:
        raise ValueError("edge_segment needs an axis-aligned plane 0")
    d = torch.randn((n_rays, 3), generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    along = torch.ones(3)
    along[axis] = 0.0
    d[0::4] = along / along.norm()
    neg = -along / along.norm()
    neg[axis] = -0.0 if float(normal[axis]) > 0 else 0.0
    d[1::4] = neg
    d[2::4, 0] = float("nan")
    o = torch.rand((n_rays, 3), generator=gen)
    st = path_start(o.to(device), d.to(device))
    t = torch.ones((n_rays,), device=device)
    idx = torch.zeros((n_rays,), dtype=torch.int32, device=device)
    g = torch.randn((n_rays, 3), generator=gen).to(device)
    return st, t, idx, g


def frame1_rays(cfg, scene, with_key: bool = False):
    """(ori, dirs) of frame 1 of an idle start: the step's window (Morton
    sorted where the configuration sorts it), camera and key; with
    ``with_key`` also the key the frame's tracer draws from."""
    ori, dirs, tkey, _ = frame1_inputs(cfg, scene)
    return (ori, dirs, tkey) if with_key else (ori, dirs)


def frame1_inputs(cfg, scene):
    """``frame1_rays``' rays and key, and the seed row of a configuration
    with ``noise_rng`` (else None): (ori, dirs, key, seed_row)."""
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.render.pipeline import camera_rays
    from mirror_maze_tpu_torch.render.scheduler import (
        chunk_origin_xy,
        chunk_pixels,
        sort_window_morton,
        take_chunks,
    )
    from mirror_maze_tpu_torch.runtime.state import init_state

    sc = cfg.screen
    st = init_state(cfg, device=scene.planes.device)
    ids, _ = take_chunks(st.perm, st.cursor, sc.effective_chunks_per_frame)
    if sc.sort_chunk_window:
        ids = sort_window_morton(ids, sc)
    pixels = chunk_pixels(chunk_origin_xy(ids, sc), sc.chunk_width)
    _, key = prng.split(st.key)
    return camera_rays(st.camera(cfg), pixels, prng.fold_in(key, 1), cfg, scene.noise)


# --- The step's glue kernels (runtime/step.py frame_setup, render/frame_glue.py) ---


def ndiff(a, b) -> int:
    """Elements of ``a`` and ``b`` whose bits differ (NaN where both are NaN
    counts as equal); -1 where dtype or shape differ."""
    if a is None or b is None:
        return 0 if a is None and b is None else -1
    if a.dtype != b.dtype or a.shape != b.shape:
        return -1
    if a.dtype.is_floating_point:
        both_nan = torch.isnan(a) & torch.isnan(b)
        return int(((bits(a) != bits(b)) & ~both_nan).sum())
    return int((a != b).sum())


def walk_into_wall(scene, cfg, state, most: int = 2000):
    """The state a W walk from ``state`` reaches just before its move first
    collides (the plain move and collision test, frame by frame), and the
    frames walked; the state as given where no move within ``most`` frames
    collides."""
    from mirror_maze_tpu_torch.runtime.step import integrate_movement, resolve_collision

    keys = torch.tensor([0.0, 0.0, 0.0, 1.0], device=state.cam_center.device)
    center = state.cam_center
    for i in range(most):
        moved = integrate_movement(cfg, center, state.quat, keys)
        after = resolve_collision(cfg, scene, moved, center)
        if torch.equal(after, center):
            return state._replace(cam_center=center), i
        center = after
    return state, most


# The configurations past the glue kernels' one-block limits: config_scale
# at 7680x4320 (1,920 x 1,080 chunks, a sorted window of 32,400 ids: the
# frame_setup kernel's tiled route) and config_interactive at 4,096 samples
# a pixel (the resolve kernel's pieces route).
BIG = {"scale-8k": ("scale", dict(width=7680, height=4320)),
       "spp4096": ("interactive", dict(samples_per_pixel=4096))}


def big_config(name: str):
    """The EngineConfig of ``BIG[name]``."""
    base, screen = BIG[name]
    cfg = P.NAMED_CONFIGS[base]()
    return cfg.replace(screen=dataclasses.replace(cfg.screen, **screen))


def glue_inputs(name: str, device):
    """(cfg, scene, state, input row, grid, row0, nearest_fn) of one input of
    the glue kernels: the frames ``chip_smoke.py``'s ``[frame-glue]`` and
    tests/test_torch_cuda.py hold the kernels on. ``name`` is
    ``config:frame``: the configuration (a key of ``P.NAMED_CONFIGS``, with
    ``bvh`` through the bvh backend; ``golden``; or ``bands`` =
    config_interactive's second band of two) and
    the frame: ``frame1`` (idle, from the initial state), ``collide`` (a W
    move into a wall), ``walk`` (a free W move), ``turn`` (a turn while
    walking). ``scale-8k`` is config_scale at 7680x4320 (a sorted window of
    32,400 ids) and ``spp4096`` config_interactive at 4,096 samples a pixel
    (``big_config``)."""
    from mirror_maze_tpu_torch.parallel import shard
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn
    from mirror_maze_tpu_torch.render.scenebuf import upload_scene
    from mirror_maze_tpu_torch.runtime.state import FrameInputs, init_state
    from mirror_maze_tpu_torch.runtime.step import input_stack

    config, frame = name.split(":")
    cfg = (golden_config() if config == "golden" else big_config(config) if config in BIG
           else P.NAMED_CONFIGS["interactive" if config == "bands" else config]())
    if config == "bvh":
        cfg = cfg.replace(intersector="bvh")    # config_bvh's scene through the walk
    scene = upload_scene(build_scene(cfg.maze), device=device)
    grid, row0 = cfg.screen, 0
    if config == "bands":
        init_fn, _ = shard.make_sharded_engine(cfg, [device] * 2)
        grid, row0 = shard._band_screen_cfg(cfg, 2), cfg.screen.height // 2
        state = init_fn(0).band(1)
    else:
        state = init_state(cfg, device=device)
    walk = FrameInputs.make(w=True)
    inp = {"frame1": FrameInputs.idle(), "collide": walk, "walk": walk,
           "turn": FrameInputs.make(w=True, mouse_dx=-27.0)}[frame]
    if frame == "collide":
        state, walked = walk_into_wall(scene, cfg, state)
        if walked == 2000:
            raise ValueError(f"{name}: no wall within 2000 frames of walking")
    row = torch.from_numpy(input_stack([inp])[0]).to(device)
    return cfg, scene, state, row, grid, row0, scene_nearest_fn(scene, cfg)


def frame_light(cfg, scene, cam, rays, setup, nearest_fn=None):
    """The light [K*spp, 3] of a frame's pinhole rays ``(ori, dirs, seed
    row)`` (through the thin lens where the configuration has one), traced
    by the configuration's tracer with the keys of ``setup`` (a
    runtime/step.py FrameSetup)."""
    from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused
    from mirror_maze_tpu_torch.render.pipeline import fused, thin_lens
    from mirror_maze_tpu_torch.render.tracer import trace_paths

    ori, dirs, seed_row = rays
    if cfg.camera.aperture > 0.0:
        ori, dirs = thin_lens(cam, ori, dirs, setup.jkey, cfg)
    if fused(cfg, nearest_fn):
        return trace_paths_fused(scene, ori, dirs, setup.seed, cfg.tracer,
                                 rows_per_block=cfg.tracer.block_rows, anchor=cam.center,
                                 seed_row=seed_row)
    return trace_paths(scene.prims, ori, dirs, setup.tkey, cfg.tracer, nearest_fn,
                       seed_row=seed_row)


def glue_check(cfg, scene, state, row, grid, row0, nearest_fn=None) -> dict:
    """Each glue kernel and its plain version on the same inputs of one
    frame, on the state's device: {buffer: elements whose bits differ}
    (``ndiff``) for every buffer a kernel writes: the setup's window, cursor,
    frame, centre, keys and seed; the camera rays' ori, dirs and seed row;
    the screen rows the resolve writes the frame's traced light into (the
    rays traced by the configuration's tracer), and the colours it writes
    without a screen. The rays and the resolve take the plain setup's
    outputs, so each kernel is held on the same inputs."""
    from mirror_maze_tpu_torch.render import frame_glue
    from mirror_maze_tpu_torch.runtime import step

    n = grid.effective_chunks_per_frame
    want = step.frame_setup_plain(scene, cfg, state, row, n, grid)
    got = step.frame_setup_kernel(scene, cfg, state, row, n, grid)
    out = {f"setup.{f}": ndiff(getattr(got, f), getattr(want, f)) for f in want._fields}
    cam = state._replace(cam_center=want.center).camera(cfg)
    win = frame_glue.Window(want.ids, grid, row0)
    rays = frame_glue.pinhole_rays_plain(cam, win, want.jkey, cfg, scene.noise)
    krays = frame_glue.pinhole_rays_kernel(cam, win, want.jkey, cfg, scene.noise)
    for name, a, b in zip(("ori", "dirs", "seed_row"), krays, rays):
        out[f"rays.{name}"] = ndiff(a, b)
    del krays
    light = frame_light(cfg, scene, cam, rays, want, nearest_fn)
    spp = cfg.screen.samples_per_pixel
    screen = state.screen
    out["resolve.screen"] = ndiff(frame_glue.resolve_kernel(light, spp, screen.clone(), want.ids),
                                  frame_glue.resolve_plain(light, spp, screen, want.ids))
    out["resolve.colours"] = ndiff(
        frame_glue.resolve_kernel(light, spp, torch.empty_like(light[::spp])),
        frame_glue.resolve_plain(light, spp))
    return out
