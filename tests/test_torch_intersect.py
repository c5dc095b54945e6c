"""The port's jnp-style intersectors (mirror_maze_tpu_torch/render/intersect.py)
against the JAX package's, on the same scene and the same NumPy-seeded rays.

Scenes: a 4x4 maze, the Cornell box with an opaque mirror sphere and a glass
sphere, the mesh gallery (360 triangles), and the giant leaf of
tests/test_intersect.py (seven coincident quads in one BVH leaf). Rule for
every backend against its JAX twin: t within rtol 1e-5 and idx equal on
>= 99% of rays (the products are summed in another order than XLA's, which
contracts multiply-adds, so an ulp may flip an edge test); the bitwise
share is printed. On the port's side the bvh walk must give bitwise the
exact backend's result, and the walk's host check every k iterations must
not change its result (k = 1 against k = 8, bitwise)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_tools import as_jax_scene
from _torch_jax_tools import one_torch_thread  # noqa: F401 (autouse)
from _torch_tools import cornell_scene, mesh_gallery_scene
from mirror_maze_tpu.render import intersect as J
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.scene.bvh import traversal_bounds as j_bounds
from mirror_maze_tpu_torch.config import MazeConfig
from mirror_maze_tpu_torch.render import intersect as T
from mirror_maze_tpu_torch.render.scenebuf import make_sphere_refresh, upload_scene
from mirror_maze_tpu_torch.scene import build_scene
from mirror_maze_tpu_torch.scene.builder import Scene
from mirror_maze_tpu_torch.scene.bvh import traversal_bounds

T_MIN = 0.1


def _giant_leaf() -> Scene:
    n = 7
    return Scene(
        origin=np.tile(np.float32([[-0.5, -0.5, 0.0]]), (n, 1)),
        v=np.tile(np.float32([[1.0, 0.0, 0.0]]), (n, 1)),
        u=np.tile(np.float32([[0.0, 1.0, 0.0]]), (n, 1)),
        color=np.ones((n, 3), np.float32), is_mirror=np.zeros(n, bool),
        emission=np.zeros((n, 4), np.float32), grid=np.zeros((1, 1), np.uint8))


def _scene(name: str) -> Scene:
    if name == "maze":
        return build_scene(MazeConfig(width=4, height=4))
    if name == "spheres":
        # A mirror sphere (opaque) and a diffuse sphere made glass.
        return dataclasses.replace(cornell_scene("spheres"), sph_ior=np.float32([0.0, 1.5]))
    if name == "mesh":
        return mesh_gallery_scene()
    return _giant_leaf()


def _rays(scene: Scene, n: int, seed: int):
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


@pytest.fixture(scope="module", params=["maze", "spheres", "mesh", "leaf"])
def case(request):
    scene = _scene(request.param)
    dev = upload_scene(scene, device="cpu")
    jdev = j_upload(as_jax_scene(scene))
    o, d = _rays(scene, 3000, seed=7)
    return request.param, dev, jdev, o, d


def _assert_rule(name, got, want):
    (t, i), (jt, ji) = got, want
    t, i = t.numpy(), i.numpy()
    jt, ji = np.asarray(jt), np.asarray(ji)
    close = np.isclose(t, jt, rtol=1e-5, atol=0).mean()
    same = (i == ji).mean()
    exact = ((t == jt) & (i == ji)).mean()
    print(f"{name}: t within rtol 1e-5 {close:.4f}, idx equal {same:.4f}, bitwise {exact:.4f}")
    assert close >= 0.99 and same >= 0.99
    assert (t < T.BIG).mean() > 0.3


def test_ray_aabb_matches_jax():
    rng = np.random.default_rng(3)
    n = 4000
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    lo = rng.uniform(-2, 0, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(1, 4, (n, 3)).astype(np.float32)
    t_cur = rng.uniform(0, 20, n).astype(np.float32)
    got = T.ray_aabb(*(torch.from_numpy(x) for x in (o, d, t_cur, lo, hi))).numpy()
    want = np.asarray(J.ray_aabb(*(jnp.asarray(x) for x in (o, d, t_cur, lo, hi))))
    assert np.array_equal(got, want)
    assert 0.1 < (got < T.BIG).mean() < 0.9


def test_sphere_ts_matches_jax():
    scene = _scene("spheres")
    dev = upload_scene(scene, device="cpu")
    jdev = j_upload(as_jax_scene(scene))
    o, d = _rays(scene, 3000, seed=5)
    got = T.sphere_ts(dev.prims, torch.from_numpy(o), torch.from_numpy(d), T_MIN).numpy()
    want = np.asarray(J.sphere_ts(jdev, jnp.asarray(o), jnp.asarray(d), T_MIN))
    close = np.isclose(got, want, rtol=1e-5, atol=0).mean()
    print(f"sphere_ts: {close:.5f} within rtol 1e-5, {(got == want).mean():.5f} bitwise")
    assert close >= 0.99
    assert (want < J.BIG).any(axis=0).all()     # both spheres are hit
    # The far root of the glass sphere (ray inside it) is taken, the opaque
    # sphere's never.
    c = scene.sph_center[1]
    inside = torch.from_numpy(np.tile(c, (4, 1)))
    ts = T.sphere_ts(dev.prims, inside, torch.from_numpy(d[:4]), T_MIN).numpy()
    assert (ts[:, 1] < T.BIG).all() and np.allclose(ts[:, 1], scene.sph_radius[1], rtol=1e-5)


def test_brute_and_exact_match_jax(case):
    name, dev, jdev, o, d = case
    to, td, jo, jd = torch.from_numpy(o), torch.from_numpy(d), jnp.asarray(o), jnp.asarray(d)
    _assert_rule(f"{name} brute", T.nearest_hit_brute(dev.prims, to, td, T_MIN),
                 J.nearest_hit_brute(jdev, jo, jd, T_MIN))
    _assert_rule(f"{name} exact", T.nearest_hit_exact(dev.prims, to, td, T_MIN),
                 J.nearest_hit_exact(jdev, jo, jd, T_MIN))


def test_bvh_matches_jax_and_exact(case):
    name, dev, jdev, o, d = case
    p = dev.prims
    depth, leaf = traversal_bounds(p.bvh_left_first.numpy(), p.bvh_count.numpy())
    assert (depth, leaf) == j_bounds(np.asarray(jdev.bvh_left_first), np.asarray(jdev.bvh_count))
    if name == "leaf":
        assert leaf == 7
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = T.nearest_hit_bvh(p, to, td, T_MIN, depth, leaf)
    want = J.nearest_hit_bvh(jdev, jnp.asarray(o), jnp.asarray(d), T_MIN, depth, leaf)
    _assert_rule(f"{name} bvh", got, want)
    # The walk against the dense exact backend on the port's side: both sum
    # the plane products left to right, so t and idx are bitwise the same
    # (on the giant leaf's exact ties too: the leaf lists its primitives in
    # scene order).
    t, i = got
    et, ei = T.nearest_hit_exact(p, to, td, T_MIN)
    assert torch.equal(t, et) and torch.equal(i, ei)


def test_bvh_result_does_not_depend_on_the_check_interval(case):
    name, dev, _, o, d = case
    p = dev.prims
    depth, leaf = traversal_bounds(p.bvh_left_first.numpy(), p.bvh_count.numpy())
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    T.walk_counts.clear()
    t1, i1 = T.nearest_hit_bvh(p, to, td, T_MIN, depth, leaf, check_every=1)
    its, syncs = T.walk_counts["iterations"], T.walk_counts["syncs"]
    assert syncs == its                      # one host check per iteration
    T.walk_counts.clear()
    t8, i8 = T.nearest_hit_bvh(p, to, td, T_MIN, depth, leaf, check_every=8)
    assert T.walk_counts["syncs"] == -(-its // 8)
    assert T.walk_counts["iterations"] == 8 * T.walk_counts["syncs"]
    assert torch.equal(t1, t8) and torch.equal(i1, i8)


def test_argmin_takes_the_first_minimum_and_ties_go_to_scene_order():
    """torch.argmin, as jnp.argmin, returns the first of equal minima; two
    coincident quads are hit at the same t and the lower scene-order id
    wins, whatever order the fused kernel's records stand in."""
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [5.0, 5.0, 5.0, 5.0]])
    assert torch.argmin(x, dim=-1).tolist() == [1, 0]
    assert np.asarray(jnp.argmin(jnp.asarray(x.numpy()), axis=-1)).tolist() == [1, 0]
    # A mirror quad of kind 2 listed first, a diffuse copy of kind 0 second:
    # the kernel's table is ordered by kind, so its first record is the
    # diffuse copy; the scene-order view keeps scene order.
    base = _giant_leaf()
    two = Scene(origin=base.origin[:2], v=base.v[:2], u=base.u[:2], color=base.color[:2],
                is_mirror=np.array([True, False]), emission=base.emission[:2],
                grid=base.grid, kind=np.uint8([2, 0]))
    dev = upload_scene(two, device="cpu")
    assert float(dev.planes[0, 18]) == 0.0 and float(dev.planes[1, 18]) == 1.0
    o = torch.tensor([[0.0, 0.0, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    for fn in (T.nearest_hit_brute, T.nearest_hit_exact):
        t, i = fn(dev.prims, o, d, T_MIN)
        assert int(i[0]) == 0 and float(t[0]) == 3.0
    t, i = T.nearest_hit_bvh(dev.prims, o, d, T_MIN, *traversal_bounds(
        dev.prims.bvh_left_first.numpy(), dev.prims.bvh_count.numpy()))
    assert float(t[0]) == 3.0
    jt, ji = J.nearest_hit_brute(j_upload(as_jax_scene(two)), jnp.asarray(o.numpy()),
                                 jnp.asarray(d.numpy()), T_MIN)
    assert int(ji[0]) == 0


def test_sphere_refresh_moves_the_scene_order_view():
    """A sphere moved on the device and refreshed is where the jnp backends
    look for it: the view equals a fresh upload of the moved scene."""
    scene = cornell_scene("spheres")
    dev = upload_scene(scene, device="cpu")
    centre = dev.sph_center.clone()
    centre[1] += torch.tensor([0.7, -0.5, 0.3])
    moved = make_sphere_refresh(dev)(dev._replace(sph_center=centre))
    fresh = upload_scene(dataclasses.replace(scene, sph_center=centre.numpy()), device="cpu")
    for f in ("sph_center", "sph_radius", "sph_inv_r", "sph_c2r2"):
        assert torch.equal(getattr(moved.prims, f), getattr(fresh.prims, f)), f
    o, d = (torch.from_numpy(x) for x in _rays(scene, 2000, seed=9))
    t_moved, i_moved = T.nearest_hit_exact(moved.prims, o, d, T_MIN)
    t_fresh, i_fresh = T.nearest_hit_exact(fresh.prims, o, d, T_MIN)
    assert torch.equal(t_moved, t_fresh) and torch.equal(i_moved, i_fresh)
    assert not torch.equal(t_moved, T.nearest_hit_exact(dev.prims, o, d, T_MIN)[0])
