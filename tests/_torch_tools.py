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
import os
import tempfile

import numpy as np
import mirror_maze_tpu_torch as P
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


def _room(half, z_min, z_max, white, left, right, light_quad) -> list:
    """The closed room of the gallery scenes (+y is down: floor at 2,
    ceiling at -8): floor, ceiling, back, front, left, right, light panel."""
    floor_y, ceil_y = 2.0, -8.0
    depth, up = z_max - z_min, (0.0, ceil_y - floor_y, 0.0)
    dark = (0, 0, 0, 0)
    return [
        ((-half, floor_y, z_min), (0, 0, depth), (2 * half, 0, 0), white, False, dark),
        ((-half, ceil_y, z_min), (2 * half, 0, 0), (0, 0, depth), white, False, dark),
        ((-half, floor_y, z_max), up, (2 * half, 0, 0), white, False, dark),
        ((-half, floor_y, z_min), up, (2 * half, 0, 0), white, False, dark),
        ((-half, floor_y, z_min), up, (0, 0, depth), left, False, dark),
        ((half, floor_y, z_min), (0, 0, depth), up, right, False, dark),
        light_quad,
    ]


GALLERY_SPAWN = (0.0, -3.0, -10.0)          # the examples' camera
CORNELL_GLASS_CENTRE = (1.6, 2.0 - 1.8, -2.2)


def _block(rows, cx, cz, half, height, theta_deg, color, mirror, floor_y=2.0) -> None:
    """An axis box rotated ``theta_deg`` about y, appended to ``rows``: four
    outward sides and a top (examples/cornell_box.py _Soup.block)."""
    th = np.deg2rad(theta_deg)
    rot = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
    base = np.array([[-half, -half], [-half, half], [half, half], [half, -half]]) @ rot.T
    base += (cx, cz)
    dark = (0, 0, 0, 0)
    for i in range(4):
        c0, c1 = base[i], base[(i + 1) % 4]
        rows.append(((c0[0], floor_y, c0[1]), (0.0, -height, 0.0),
                     (c1[0] - c0[0], 0.0, c1[1] - c0[1]), color, mirror, dark))
    c0, c1, c3 = base[0], base[1], base[3]
    rows.append(((c0[0], floor_y - height, c0[1]), (c3[0] - c0[0], 0.0, c3[1] - c0[1]),
                 (c1[0] - c0[0], 0.0, c1[1] - c0[1]), color, mirror, dark))


def cornell_scene(variant: str) -> Scene:
    """The Cornell box of examples/cornell_box.py build_cornell_box, variant
    ``blocks`` (a short diffuse and a tall mirror block, 17 quads),
    ``spheres`` (a mirror and a diffuse sphere: test mode 3) or ``glass`` (a
    glass sphere beside a tall mirror block: mode 5), built with the port's
    Scene (test_torch_scene.py holds it equal to the example's, array for
    array)."""
    white = (0.725, 0.71, 0.68)
    rows = _room(5.0, -10.5, 5.0, white, (0.63, 0.065, 0.05), (0.14, 0.45, 0.091),
                 ((-2.0, -8.0 + 0.01, -1.75), (0, 0, 3.5), (4.0, 0, 0), (0.0, 0.0, 0.0), False,
                  (1.0, 0.85, 0.55, 34.0)))
    floor_y = 2.0
    if variant == "spheres":
        r_mirror, r_diff = 2.2, 1.5
        return dataclasses.replace(
            _quad_scene(rows),
            sph_center=np.float32([[-2.0, floor_y - r_mirror, 1.8], [2.0, floor_y - r_diff, -1.7]]),
            sph_radius=np.float32([r_mirror, r_diff]),
            sph_color=np.float32([(0, 0, 0), white]),
            sph_is_mirror=np.array([True, False]),
            sph_emission=np.zeros((2, 4), np.float32),
            sph_ior=np.zeros(2, np.float32),
        )
    if variant == "blocks":
        _block(rows, 2.0, -1.7, 1.5, 3.0, -17.0, white, False)
        _block(rows, -2.0, 1.8, 1.5, 6.0, 17.0, white, True)
        return _quad_scene(rows)
    if variant != "glass":
        raise ValueError(f"variant must be 'blocks', 'spheres' or 'glass', got {variant!r}")
    _block(rows, -2.0, 1.8, 1.5, 6.0, 17.0, white, True)
    return dataclasses.replace(
        _quad_scene(rows),
        sph_center=np.float32([CORNELL_GLASS_CENTRE]),
        sph_radius=np.float32([1.8]),
        sph_color=np.float32([(0.94, 0.97, 1.0)]),
        sph_is_mirror=np.array([False]),
        sph_emission=np.zeros((1, 4), np.float32),
        sph_ior=np.float32([1.5]),
    )


def checker_floor(scene: Scene, cells: float = 8.0, color2=(0.25, 0.25, 0.3)) -> Scene:
    """The scene with its floor (plane 0) a UV checker, ``tex_kind`` 1
    (examples/cornell_box.py checker_floor)."""
    kind = np.zeros(scene.num_planes, np.uint8)
    scale = np.ones(scene.num_planes, np.float32)
    color = np.zeros((scene.num_planes, 3), np.float32)
    kind[0], scale[0], color[0] = 1, cells, color2
    return dataclasses.replace(scene, tex_kind=kind, tex_scale=scale, tex_color2=color)


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
    """The mesh gallery of examples/mesh_gallery.py build_mesh_gallery: a room
    of 7 quads, a 320-triangle mirror icosphere and two 20-triangle gems (the
    second through an OBJ file), built with the port's scene/mesh.py."""
    floor_y = 2.0
    room = _quad_scene(_room(
        6.0, -11.0, 5.0, (0.73, 0.71, 0.68), (0.62, 0.08, 0.06), (0.12, 0.43, 0.09),
        ((-2.5, -8.0 + 0.01, -2.5), (0, 0, 5.0), (5.0, 0, 0), (0.0, 0.0, 0.0), False,
         (1.0, 0.85, 0.55, 30.0))))
    sv, sf = mesh.icosphere(subdivisions=2, radius=2.0, center=(-2.4, floor_y - 2.0, 1.2))
    mirror_ball = mesh.mesh_scene(sv, sf, color=(0.0, 0.0, 0.0), is_mirror=True)
    gv, gf = mesh.icosphere(subdivisions=0, radius=1.4)
    gv = mesh.transform_vertices(gv, rotate_y_deg=20.0, translate=(2.6, floor_y - 1.5, -1.8))
    gem = mesh.mesh_scene(gv, gf, color=(0.9, 0.55, 0.15), emission=(1.0, 0.6, 0.2, 0.25))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "gem.obj")
        mesh.save_obj(path, gv, gf)
        ov, of = mesh.load_obj(path)
    gem2 = mesh.mesh_scene(
        mesh.transform_vertices(ov, scale=0.7, rotate_y_deg=-35.0, translate=(-2.2, 0.0, -3.4)),
        of, color=(0.25, 0.5, 0.9))
    return mesh.merge_scenes(room, mirror_ball, gem, gem2)


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
