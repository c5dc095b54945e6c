"""Host scene build, plane table, sphere table, tile table, noise texture,
collision boxes and the mesh toolkit: the port against the JAX package,
bitwise."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tools import cornell_scene, mesh_gallery_scene, primitive_zoo, soup_arrays
from mirror_maze_tpu.config import MazeConfig as JMaze
from mirror_maze_tpu.render.pallas_tracer import build_sphere_table as j_sphere_table
from mirror_maze_tpu.render.pallas_tracer import pack_intersection_tables
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu.scene.bvh import build_bvh as j_bvh
from mirror_maze_tpu.scene.builder import Scene as JScene
from mirror_maze_tpu.scene.bvh import traversal_bounds as j_bounds
from mirror_maze_tpu.scene import mesh as j_mesh
from mirror_maze_tpu.utils import noise as j_noise
from mirror_maze_tpu_torch.config import MazeConfig
from mirror_maze_tpu_torch.render.scenebuf import (
    build_sphere_table,
    plane_modes,
    plane_records,
    sphere_records,
    tile_table,
    upload_scene,
)
from mirror_maze_tpu_torch.scene import build_scene, mesh
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
    # The tracer records are the table's first 19 columns plus the ior, in
    # table order (a maze of opaque quads is already grouped mode 0, 1, 2, as
    # the kernel's groups are), and the tile table names each tile's mode.
    table = pdev.plane_table.numpy()
    rec = pdev.planes.numpy()
    _bitwise(rec[:, :19], table[:, :19])
    _bitwise(rec[:, 19], table[:, 27])
    n0, n1, n2 = pdev.mode_counts[:3]
    assert (n0, n1, n2) == tuple(int((table[:, 26] == m).sum()) for m in (0, 1, 2))
    assert sum(pdev.mode_counts[3:]) == 0 and not pdev.has_glass
    tiles = pdev.tiles.numpy()
    for t in tiles:
        assert np.all(table[int(t[6]):int(t[6] + t[7]), 26] == t[8])


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
    assert all(n > 0 for n in dev.mode_counts[:3]) and not any(dev.mode_counts[3:])
    assert dev.leaf_min.shape == (78, 3)


def test_unported_primitives_raise():
    """Nothing is left that the fused tracer refuses at upload: triangles,
    glass and textures are all taken. A texture adds the texture rows (in
    record order) and changes no other table."""
    table = np.zeros((2, 40), np.float32)
    table[:, 19] = 1.0
    table[1, 26] = 3.0                     # a triangle
    table[0, 27] = 1.5                     # a glass quad
    rec, counts = plane_records(table)
    assert counts == (0, 0, 0, 0, 1, 0, 1, 0) and rec[:, 19].tolist() == [0.0, 1.5]
    table[1, 28] = 1.0                     # a checker texture
    rec2, counts2 = plane_records(table)
    assert counts2 == counts and np.array_equal(rec2, rec)
    plain = cornell_scene("spheres")
    textured = dataclasses.replace(plain, sph_tex_kind=np.uint8([2, 0]),
                                   sph_tex_scale=np.float32([0.5, 1.0]),
                                   sph_tex_color2=np.float32([[0.1, 0.2, 0.3], [0, 0, 0]]))
    a, b = upload_scene(plain, device="cpu"), upload_scene(textured, device="cpu")
    assert not a.textured and a.plane_tex.shape == a.sphere_tex.shape == (0, 8)
    assert b.textured and b.plane_tex.shape == (7, 8) and b.sphere_tex.shape == (2, 8)
    assert b.sphere_tex[:, 0:5].tolist() == [[2.0, 0.5] + [float(np.float32(c)) for c in
                                                           (0.1, 0.2, 0.3)], [0.0, 1.0, 0, 0, 0]]
    assert not b.plane_tex[:, 0].any() and (b.plane_tex[:, 1] == 1.0).all()
    for f in ("planes", "spheres", "tiles", "leaf_min", "leaf_max"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


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


def _as_jax_scene(scene):
    return JScene(**{f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)})


ZOO_TILES = {1: 16, 3: 4, 4: 16, 5: 2, 6: 8, 7: 8}
EIGHT_MODE_CASES = {
    "zoo": (lambda: primitive_zoo(8), None),
    "zoo_small_tiles": (lambda: primitive_zoo(8), ZOO_TILES),
    "zoo4_tiles_of_3": (lambda: primitive_zoo(4), {m: 3 for m in range(8)}),
    "cornell_glass": (lambda: cornell_scene("glass"), None),
    "cornell_spheres": (lambda: cornell_scene("spheres"), {3: 1}),
    "mesh_gallery": (mesh_gallery_scene, None),
    "glass_maze10": (lambda: build_scene(MazeConfig(width=10, height=10, glass_prob=0.5)), None),
    "glass_maze16_tiles": (lambda: build_scene(MazeConfig(width=16, height=16, glass_prob=0.5)),
                           {1: 32, 6: 4}),
}


@pytest.mark.parametrize("case", list(EIGHT_MODE_CASES))
def test_eight_mode_upload_bitwise(case):
    """A scene with spheres, triangles and glass uploaded by both packages:
    the same ordered plane table, sphere table and collision boxes; the
    same partition into the eight test modes' tiles with the same boxes;
    the groups in the kernel's merge order; and the port's records are the
    tables' rows, group by group in table order."""
    make, tbm = EIGHT_MODE_CASES[case]
    scene = make()
    jscene = _as_jax_scene(scene)
    jdev = j_upload(jscene)
    pdev = upload_scene(scene, device="cpu", tile_by_mode=tbm)
    table = np.asarray(jdev.plane_table)
    _bitwise(pdev.plane_table.numpy(), table)
    sph = j_sphere_table(jscene)
    _bitwise(pdev.sphere_table.numpy(), sph)
    _bitwise(build_sphere_table(scene), sph)
    _bitwise(pdev.leaf_min.numpy(), np.asarray(jdev.leaf_min))
    _bitwise(pdev.leaf_max.numpy(), np.asarray(jdev.leaf_max))

    packed = pack_intersection_tables(table, tile_by_mode=tbm,
                                      sphere_table=sph if len(sph) else None)
    tiles, meta = pdev.tiles.numpy(), pdev.group_meta
    present = [m for m in range(8) if packed[m] is not None]
    assert sorted(g[0] for g in meta) == present
    n_tiles = {m: packed[m][2].shape[0] for m in present}
    assert [g[0] for g in meta] == sorted(present, key=lambda m: (n_tiles[m] > 1, -n_tiles[m]))
    assert sum(g[2] for g in meta) == len(tiles)
    assert pdev.has_glass == any(m in (5, 6, 7) for m in present)
    modes = plane_modes(table)
    sph_modes = np.where(sph[:, 12] > 0, 5, 3)
    rec, srec = pdev.planes.numpy(), pdev.spheres.numpy()
    for mode, first, n in meta:
        assert n == n_tiles[mode]
        _bitwise(tiles[first:first + n, 0:6], np.asarray(packed[mode][2])[:, 0:6])
        assert np.all(tiles[first:first + n, 8] == mode)
        starts = tiles[first:first + n, 6].astype(int)
        counts = tiles[first:first + n, 7].astype(int)
        assert np.all(starts[1:] == starts[:-1] + counts[:-1])
        got_rows = slice(starts[0], starts[0] + counts.sum())
        if mode in (3, 5):
            want = sph[sph_modes == mode]
            assert pdev.mode_counts[mode] == len(want) == counts.sum()
            _bitwise(srec[got_rows][:, [0, 1, 2, 12, 3]], want[:, 0:5])
            _bitwise(srec[got_rows][:, 4:12], want[:, 5:13])
        else:
            want = table[modes == mode]
            assert pdev.mode_counts[mode] == len(want) == counts.sum()
            _bitwise(rec[got_rows][:, :19], want[:, :19])
            _bitwise(rec[got_rows][:, 19], want[:, 27])
    _bitwise(rec, plane_records(table)[0])
    _bitwise(srec, sphere_records(sph))


def _load_example(name):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", name + ".py")
    spec = importlib.util.spec_from_file_location("_example_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["cornell_spheres", "cornell_glass", "mesh_gallery"])
def test_gallery_scenes_are_the_examples(name):
    """The JAX-free gallery scenes of tests/_torch_tools.py, array for array
    the scenes the JAX package's examples build."""
    if name == "mesh_gallery":
        got, want = mesh_gallery_scene(), _load_example("mesh_gallery").build_mesh_gallery()
        assert int((np.asarray(got.kind) == 3).sum()) == 360 and got.num_planes == 367
    else:
        variant = name.split("_")[1]
        got, want = cornell_scene(variant), _load_example("cornell_box").build_cornell_box(variant)
        assert got.num_spheres == {"spheres": 2, "glass": 1}[variant]
    for f in dataclasses.fields(got):
        _bitwise(getattr(got, f.name), getattr(want, f.name))


def test_mesh_toolkit_bitwise(tmp_path):
    """scene/mesh.py against the JAX package's: icosphere, transform, OBJ
    round trip, mesh_scene and merge_scenes."""
    for sub in (0, 1, 2):
        pv, pf = mesh.icosphere(sub, radius=1.7, center=(0.5, -1.0, 2.0))
        jv, jf = j_mesh.icosphere(sub, radius=1.7, center=(0.5, -1.0, 2.0))
        _bitwise(pv, jv)
        _bitwise(pf, jf)
        assert len(pf) == 20 * 4 ** sub
    kw = dict(scale=0.7, rotate_y_deg=-35.0, translate=(-2.2, 0.0, -3.4))
    _bitwise(mesh.transform_vertices(pv, **kw), j_mesh.transform_vertices(jv, **kw))
    mesh.save_obj(str(tmp_path / "p.obj"), pv, pf)
    j_mesh.save_obj(str(tmp_path / "j.obj"), jv, jf)
    assert (tmp_path / "p.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    for y_down in (True, False):
        lv, lf = mesh.load_obj(str(tmp_path / "j.obj"), y_down=y_down)
        wv, wf = j_mesh.load_obj(str(tmp_path / "j.obj"), y_down=y_down)
        _bitwise(lv, wv)
        _bitwise(lf, wf)
    _bitwise(lv * np.float32([1, -1, 1]), pv * np.float32([1, -1, 1]) * np.float32([1, -1, 1]))
    a = mesh.mesh_scene(pv, pf, color=(0.2, 0.3, 0.4), is_mirror=True, ior=1.4)
    b = j_mesh.mesh_scene(jv, jf, color=(0.2, 0.3, 0.4), is_mirror=True, ior=1.4)
    merged = mesh.merge_scenes(cornell_scene("glass"), a)
    jmerged = j_mesh.merge_scenes(_as_jax_scene(cornell_scene("glass")), b)
    for f in dataclasses.fields(merged):
        _bitwise(getattr(merged, f.name), getattr(jmerged, f.name))
    with pytest.raises(ValueError):
        mesh.mesh_scene(pv, pf + len(pv))


def _textured_zoo():
    """The zoo of all eight modes with random textures on half its planes
    (kind 1 or 2) and spheres (kind 2)."""
    scene = primitive_zoo()
    r = np.random.default_rng(4)
    n, s = scene.num_planes, scene.num_spheres
    return dataclasses.replace(
        scene,
        tex_kind=(r.integers(1, 3, n) * (r.random(n) < 0.5)).astype(np.uint8),
        tex_scale=r.uniform(0.3, 4.0, n).astype(np.float32),
        tex_color2=r.uniform(0, 1, (n, 3)).astype(np.float32),
        sph_tex_kind=(2 * (r.random(s) < 0.5)).astype(np.uint8),
        sph_tex_scale=r.uniform(0.3, 2.0, s).astype(np.float32),
        sph_tex_color2=r.uniform(0, 1, (s, 3)).astype(np.float32))


def test_texture_rows_are_the_reference_second_property_block():
    """A textured scene's texture rows and records hold, primitive for
    primitive, what the reference packs into its second property block
    (tex_kind, tex_scale, tex_color2, and for planes w1, b1, w2, b2), in the
    reference's group order; the untextured zoo uploads nothing more."""
    scene = _textured_zoo()
    dev = upload_scene(scene, device="cpu")
    assert dev.textured and not upload_scene(primitive_zoo(), device="cpu").textured
    jscene = JScene(**{f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)})
    table = np.asarray(j_upload(jscene).plane_table)
    groups = pack_intersection_tables(table, sphere_table=j_sphere_table(jscene))
    first = {False: 0, True: 0}
    for mode, group in enumerate(groups):
        assert group is not None
        _, props_t, _ = group
        assert props_t.shape[1] == 64                       # doubled, split hi + lo
        n = dev.mode_counts[mode]
        props = (props_t[:, :32] + props_t[:, 32:]).transpose(0, 2, 1).reshape(-1, 32)[:n]
        sph = mode in (3, 5)
        a = first[sph]
        tex = (dev.sphere_tex if sph else dev.plane_tex)[a:a + n].numpy()
        np.testing.assert_array_equal(tex[:, 0:5], props[:, 16:21], err_msg=f"mode {mode}")
        if not sph:
            np.testing.assert_array_equal(dev.planes[a:a + n, 4:12].numpy(), props[:, 21:29])
        first[sph] += n


def test_sphere_refresh_matches_jax():
    """``make_sphere_refresh`` against the JAX package's: untouched, it gives
    back the uploaded tables; after two centres move on the device (and
    ``sph_c2r2`` with them on the reference's side, summed in float64 as at
    upload), the records hold what the reference repacks into its sphere
    groups, bitwise, and the sphere tiles' boxes are the reference's."""
    from mirror_maze_tpu.render.scenebuf import make_sphere_refresh as j_make_refresh
    from mirror_maze_tpu_torch.render.scenebuf import make_sphere_refresh

    scene = primitive_zoo()
    dev = upload_scene(scene, device="cpu")
    refresh = make_sphere_refresh(dev)
    same = refresh(dev)
    for f in ("sphere_table", "spheres", "tiles"):
        assert torch.equal(getattr(same, f), getattr(dev, f)), f
    assert make_sphere_refresh(upload_scene(build_scene(MazeConfig(width=4, height=4)),
                                            device="cpu")) is None

    centre = np.asarray(scene.sph_center, np.float32).copy()
    centre[0] += np.float32([3.25, -0.5, 1.125])
    centre[3] = np.float32([-7.3, -2.2, 9.1])                    # 3 is a glass sphere
    moved = refresh(dev._replace(sph_center=torch.from_numpy(centre)))
    assert not torch.equal(moved.spheres, dev.spheres)
    assert torch.equal(moved.leaf_min, dev.leaf_min)             # collision stays put

    jscene = JScene(**{f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)})
    jdev = j_upload(jscene)
    radius = np.asarray(scene.sph_radius, np.float32)
    c2r2 = (np.sum(centre.astype(np.float64) ** 2, axis=-1)
            - radius.astype(np.float64) ** 2).astype(np.float32)
    jmoved = jax.jit(j_make_refresh(jdev))(
        jdev._replace(sph_center=jnp.asarray(centre), sph_c2r2=jnp.asarray(c2r2)))
    first = 0
    tiles = {int(t[8]): t for t in moved.tiles.numpy()}
    for mode in (3, 5):
        w, props_t, aabbs = (np.asarray(a) for a in jmoved.mxu_tables[mode])
        n = dev.mode_counts[mode]
        props = (props_t[:, :16] + props_t[:, 16:]).transpose(0, 2, 1).reshape(-1, 16)[:n]
        rec = moved.spheres[first:first + n].numpy()
        np.testing.assert_array_equal(rec[:, 0:3], props[:, 0:3])        # centre
        np.testing.assert_array_equal(rec[:, 12], props[:, 10])          # 1 / r
        np.testing.assert_array_equal(rec[:, 3], w[0, w.shape[1] // 2:, 3][:n])   # c2r2
        np.testing.assert_array_equal(tiles[mode][0:6], aabbs[0, 0:6])
        first += n
    # What the upload gives for the moved scene is what the refresh gave.
    again = upload_scene(dataclasses.replace(scene, sph_center=centre), device="cpu")
    for f in ("sphere_table", "spheres", "tiles"):
        assert torch.equal(getattr(moved, f), getattr(again, f)), f
