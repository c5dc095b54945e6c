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
not change its result (k = 1 against k = 8, bitwise).

The walk kernel (csrc/bvh_walk.cu) runs only on the card; here its
algorithm, one ray walked alone to its end with the kernel's NaN rule and
stack clamp, then the kernel's sphere fold, is followed in NumPy float32
(``scalar_walk``, ``scalar_sphere_fold``) and held bitwise against the
plain walk on the four scenes, on rays with exact zero direction
components, and with a stack too shallow for the tree; the fold alone
against ``_merge_spheres`` with the glass sphere's far root; and
``bvh_tables``' rows read by the plain walk against the JAX walk."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_tools import as_jax_scene
from _torch_jax_tools import one_torch_thread  # noqa: F401 (autouse)
from _torch_tools import (
    INTERSECT_SCENES,
    cornell_scene,
    giant_leaf_scene,
    intersect_scene,
    scene_rays,
    zero_component_rays,
)
from mirror_maze_tpu.render import intersect as J
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.scene.bvh import traversal_bounds as j_bounds
from mirror_maze_tpu_torch.render import intersect as T
from mirror_maze_tpu_torch.render.scenebuf import make_sphere_refresh, upload_scene
from mirror_maze_tpu_torch.scene.builder import Scene
from mirror_maze_tpu_torch.scene.bvh import traversal_bounds

T_MIN = 0.1


_giant_leaf = giant_leaf_scene
_scene = intersect_scene
_rays = scene_rays


@pytest.fixture(scope="module", params=list(INTERSECT_SCENES))
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


# --- The walk kernel's algorithm, one ray at a time ---------------------------

F32_BIG = np.float32(T.BIG)


def _scalar_slab(box, o, inv, t_cur, nans):
    """csrc/bvh_walk.cu slab(): one NaN among the six distances is a miss
    (counted into ``nans``), else the entry distance or BIG."""
    ts = [(box[a] - o[a]) * inv[a] for a in range(3)] + [(box[3 + a] - o[a]) * inv[a]
                                                        for a in range(3)]
    if any(np.isnan(x) for x in ts):
        nans[0] += 1
        return F32_BIG
    tn = max(min(ts[0], ts[3]), min(ts[1], ts[4]), min(ts[2], ts[5]))
    tf = min(max(ts[0], ts[3]), max(ts[1], ts[4]), max(ts[2], ts[5]))
    return tn if (tf >= tn and tn < t_cur and tf > 0) else F32_BIG


def scalar_walk(noderow, leafpack, o, d, t_min, max_depth, max_leaf, nans):
    """csrc/bvh_walk.cu's walk of ONE ray, statement for statement, in NumPy
    float32 scalars: (t, idx) of the nearest plane hit."""
    n_levels, n_slots = max_depth + 2, leafpack.shape[0]
    inv = [np.float32(1.0) / d[a] for a in range(3)]
    t, idx = F32_BIG, 0
    stack, sp, cur = [0] * n_levels, 0, 0
    for _ in range(noderow.shape[0]):
        nr = noderow[cur]
        ct, lf = int(nr[12]), int(nr[13])
        if ct >= 1:
            lp = leafpack[min(max(lf, 0), n_slots - 1)]
            for k in range(min(ct, max_leaf)):
                pk = lp[15 * k:15 * (k + 1)]
                denom = (d[0] * pk[0] + d[1] * pk[1]) + d[2] * pk[2]
                tk = (pk[3] - ((o[0] * pk[0] + o[1] * pk[1]) + o[2] * pk[2])) / denom
                x = [o[a] + tk * d[a] for a in range(3)]
                s1 = ((x[0] * pk[4] + x[1] * pk[5]) + x[2] * pk[6]) - pk[7]
                s2 = ((x[0] * pk[8] + x[1] * pk[9]) + x[2] * pk[10]) - pk[11]
                inside = s1 + s2 <= 1 if pk[14] > 0 else (s1 <= 1 and s2 <= 1)
                if (pk[12] > 0 and denom != 0 and tk > t_min and s1 >= 0 and s2 >= 0 and inside
                        and tk < t):
                    t, idx = tk, int(pk[13])
        else:
            d1 = _scalar_slab(nr[0:6], o, inv, t, nans)
            d2 = _scalar_slab(nr[6:12], o, inv, t, nans)
            first = d1 <= d2
            if min(d1, d2) < F32_BIG:
                if max(d1, d2) < F32_BIG:
                    stack[min(sp, n_levels - 1)] = lf + 1 if first else lf
                    sp += 1
                cur = lf if first else lf + 1
                continue
        if sp == 0:
            break
        sp -= 1
        cur = stack[sp] if sp < n_levels else 0
    return t, idx


def scalar_sphere_fold(centre, c2r2, ior, n_planes, o, d, t_min, t, idx, far):
    """csrc/bvh_walk.cu's sphere fold after the walk of ONE ray, in NumPy
    float32 scalars: the first least sphere distance replaces (t, idx) where
    strictly nearer; ``far[0]`` counts the glass far roots taken."""
    f32 = np.float32
    sdo = (o[0] * d[0] + o[1] * d[1]) + o[2] * d[2]
    soo = (o[0] * o[0] + o[1] * o[1]) + o[2] * o[2]
    ts_min, s_idx = F32_BIG, 0
    for s in range(centre.shape[0]):
        c = centre[s]
        b = sdo - ((d[0] * c[0] + d[1] * c[1]) + d[2] * c[2])
        q = soo + (((o[0] * (f32(-2) * c[0]) + o[1] * (f32(-2) * c[1])) + o[2] * (f32(-2) * c[2]))
                   + c2r2[s])
        disc = b * b - q
        root = f32(np.sqrt(np.float64(max(disc, f32(0)))))     # correctly rounded
        ts = -b - root
        ok = disc > 0 and ts > t_min
        if not ok and ior is not None:
            tf = -b + root
            if disc > 0 and tf > t_min and ior[s] > 0:
                ts, ok = tf, True
                far[0] += 1
        if ok and ts < ts_min:
            ts_min, s_idx = ts, s
    if ts_min < t:
        return ts_min, n_planes + s_idx
    return t, idx


def _scalar_fold_all(p, o, d, t, idx, far):
    """``scalar_sphere_fold`` over rays [R, 3] and plane hits (t, idx)."""
    centre, c2r2 = p.sph_center.numpy(), p.sph_c2r2.numpy()
    ior = p.sph_ior.numpy() if p.sph_ior is not None else None
    rows = [scalar_sphere_fold(centre, c2r2, ior, p.num_planes, o[i], d[i], np.float32(T_MIN),
                               np.float32(t[i]), int(idx[i]), far)
            for i in range(o.shape[0])]
    return (torch.from_numpy(np.array([r[0] for r in rows], np.float32)),
            torch.from_numpy(np.array([r[1] for r in rows], np.int32)))


def _scalar_vs_plain(dev, o, d, depth, leaf):
    """(scalar walk + the kernel's sphere fold, plain walk, slab NaNs met)."""
    p = dev.prims
    tables = T.bvh_tables(p, leaf)
    noderow, leafpack = tables.noderow.numpy(), tables.leafpack.numpy()
    nans = [0]
    with np.errstate(all="ignore"):
        rows = [scalar_walk(noderow, leafpack, o[i], d[i], np.float32(T_MIN), depth, leaf, nans)
                for i in range(o.shape[0])]
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t = np.array([r[0] for r in rows], np.float32)
    i = np.array([r[1] for r in rows], np.int32)
    if p.num_spheres:
        with np.errstate(all="ignore"):
            t, i = _scalar_fold_all(p, o, d, t, i, [0])
    else:
        t, i = torch.from_numpy(t), torch.from_numpy(i)
    return (t, i), T.nearest_hit_bvh(p, to, td, T_MIN, depth, leaf, tables=tables), nans[0]


SCALAR_RAYS = 200


@pytest.mark.parametrize("rays", ["random", "zero_components", "tight_stack"])
def test_scalar_walk_is_bitwise_the_plain_walk(case, rays):
    """The kernel's per-ray walk against the plain vector walk: t and idx
    bitwise on every ray. ``zero_components``: rays with exact zero
    direction components from points on box faces, where the slab test
    meets NaN; ``tight_stack``: max_depth - 3 levels, the fewest a walk can
    need (a ray holds at most one pending node a level below the root)."""
    name, dev, _, o, d = case
    p = dev.prims
    depth, leaf = traversal_bounds(p.bvh_left_first.numpy(), p.bvh_count.numpy())
    if rays == "zero_components":
        o, d = zero_component_rays(_scene(name), SCALAR_RAYS, seed=11)
    else:
        o, d = o[:SCALAR_RAYS], d[:SCALAR_RAYS]
    if rays == "tight_stack":
        depth = max(depth - 3, 0)
    (t, i), (pt, pi), nans = _scalar_vs_plain(dev, o, d, depth, leaf)
    assert torch.equal(t.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(i, pi)
    assert (t < T.BIG).mean(dtype=torch.float32) > 0.05
    if rays == "zero_components" and name != "leaf":
        assert nans > 0
        assert (d == 0).any(axis=1).all()


def test_sphere_fold_in_the_kernel_is_bitwise_merge_spheres():
    """The kernel's sphere fold, ray by ray, against ``_merge_spheres`` on
    the Cornell box with a mirror and a glass sphere: random rays, rays
    from inside the glass sphere (its far root) and from inside the mirror
    one (no root), over plane hits that are nearer, farther and tied."""
    scene = _scene("spheres")
    p = upload_scene(scene, device="cpu").prims
    rng = np.random.default_rng(13)
    o, d = _rays(scene, 600, seed=17)
    n_in = 150
    for s, rows in ((1, slice(0, n_in)), (0, slice(n_in, 2 * n_in))):
        r = scene.sph_radius[s]
        o[rows] = (scene.sph_center[s]
                   + rng.uniform(-0.5, 0.5, (n_in, 3)) * r).astype(np.float32)
    t, idx = T.nearest_hit_exact(p._replace(sph_center=p.sph_center[:0],
                                            sph_c2r2=p.sph_c2r2[:0]), *map(torch.from_numpy,
                                                                            (o, d)), T_MIN)
    t, idx = t.numpy().copy(), idx.numpy().copy()
    t[::5] = rng.uniform(0.0, 2.0, t[::5].shape).astype(np.float32)   # planes nearer
    far = [0]
    got = _scalar_fold_all(p, o, d, t, idx, far)
    want = T._merge_spheres(p, torch.from_numpy(o), torch.from_numpy(d), T_MIN,
                            torch.from_numpy(t), torch.from_numpy(idx))
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert far[0] >= n_in // 2                          # the glass sphere's far root
    spheres = (want[1] >= p.num_planes).numpy()
    assert spheres.mean() > 0.2 and (~spheres).mean() > 0.2
    inside_glass = (want[1] == p.num_planes + 1).numpy()[:n_in]
    assert inside_glass[np.arange(n_in) % 5 != 0].all()   # but where a plane was set nearer


@pytest.mark.parametrize("name", list(INTERSECT_SCENES))
def test_plain_walk_on_the_tables_is_the_jax_walk(name):
    """``bvh_tables``' rows read by the plain walk against the JAX package's
    ``nearest_hit_bvh`` on the same rays: bitwise on the planes-only scenes
    (the maze, the giant leaf), by the module's rule where triangles or
    spheres round otherwise; and the tables hold the tree's counts, links
    and slots as exact floats, a leaf's run of slots in one row."""
    scene = _scene(name)
    dev = upload_scene(scene, device="cpu")
    p = dev.prims
    depth, leaf = traversal_bounds(p.bvh_left_first.numpy(), p.bvh_count.numpy())
    tables = T.bvh_tables(p, leaf)
    assert tables.noderow.shape == (p.bvh_min.shape[0], 14)
    assert tables.leafpack.shape == (p.num_planes, 15 * leaf)
    assert torch.equal(tables.noderow[:, 12].long(), p.bvh_count)
    assert torch.equal(tables.noderow[:, 13].long(), p.bvh_left_first)
    assert torch.equal(tables.leafpack[:, 13].long(), p.bvh_prim)
    o, d = _rays(scene, 3000, seed=23)
    got = T.nearest_hit_bvh(p, torch.from_numpy(o), torch.from_numpy(d), T_MIN, depth, leaf,
                            tables=tables)
    want = J.nearest_hit_bvh(j_upload(as_jax_scene(scene)), jnp.asarray(o), jnp.asarray(d),
                             T_MIN, depth, leaf)
    if name in ("maze", "leaf"):
        assert np.array_equal(got[0].numpy().view(np.int32), np.asarray(want[0]).view(np.int32))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    _assert_rule(f"{name} bvh tables", got, want)


def test_walk_kernel_raises_instead_of_falling_back(monkeypatch):
    """The kernel wrapper raises on CPU tensors and on a tree deeper than
    its stack; it never runs the plain walk."""
    dev = upload_scene(intersect_scene("maze"), device="cpu")
    o, d = (torch.from_numpy(x) for x in scene_rays(intersect_scene("maze"), 8, seed=1))
    monkeypatch.setattr(T, "nearest_hit_bvh", lambda *a, **k: pytest.fail("fell back"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        T.nearest_hit_bvh_kernel(dev.prims, o, d, T_MIN, 7, 2)
    with pytest.raises(ValueError, match="stack levels"):
        T.nearest_hit_bvh_kernel(dev.prims, o, d, T_MIN, T.BVH_STACK - 1, 2)


def test_walk_kernel_stack_and_library_match_the_source():
    """``BVH_STACK`` is the kernel's MM_BVH_STACK, deep enough for every named
    scene's tree; the library ``bvh_walk`` builds from csrc/bvh_walk.cu; and
    a bvh backend made on the CPU walks with the plain version."""
    import re

    from mirror_maze_tpu_torch import config, kernels
    from mirror_maze_tpu_torch.render.pipeline import make_nearest_fn
    from mirror_maze_tpu_torch.scene import build_scene
    from mirror_maze_tpu_torch.scene.bvh import build_bvh

    src = (kernels.CSRC / "bvh_walk.cu").read_text()
    assert int(re.search(r"#define MM_BVH_STACK (\d+)", src).group(1)) == T.BVH_STACK
    assert kernels.LIBRARIES["bvh_walk"][0] == "bvh_walk.cu"
    assert kernels.LIBRARIES["bvh_walk"][2][0] in src
    for name, make in config.NAMED_CONFIGS.items():
        if name == "scale":
            continue    # its tree (depth 17) is checked in test_torch_scene.py's time budget
        s = build_scene(make().maze)
        bvh = build_bvh(s.origin, s.u, s.v)
        assert traversal_bounds(bvh.left_first, bvh.count)[0] + 2 <= T.BVH_STACK, name
    cfg = config.config_bvh().replace(intersector="bvh")
    scene = intersect_scene("maze")
    dev = upload_scene(scene, device="cpu")
    o, d = (torch.from_numpy(x) for x in scene_rays(scene, 64, seed=2))
    depth, leaf = traversal_bounds(dev.prims.bvh_left_first.numpy(), dev.prims.bvh_count.numpy())
    T.walk_counts.clear()
    t, i = make_nearest_fn(dev, cfg, depth, leaf)(o, d)
    assert T.walk_counts["walks"] == 1
    want = T.nearest_hit_bvh(dev.prims, o, d, cfg.tracer.t_min, depth, leaf)
    assert torch.equal(t, want[0]) and torch.equal(i, want[1])
