"""Ray-scene intersection over the scene-order view (counterpart of the JAX
package's ``render/intersect.py``): the slab and sphere primitives and the
three nearest-hit backends of the jnp tracer.

- ``nearest_hit_brute``: every ray against every plane through six
  [R,3]x[3,P] products (``torch.matmul``; TF32 is never enabled in the
  package) and the vectorized in-rectangle tests;
- ``nearest_hit_exact``: the same dense test with each product written as
  three multiplies summed left to right;
- ``nearest_hit_bvh``: the reference's near-child-first stack traversal
  (`shaders.metal:115-156`), vectorized over rays with a stack per ray and
  a liveness mask.

Each returns (t [R], idx [R] int32) with t = BIG for a miss; idx is a
scene-order id (sphere i is ``num_planes + i``), and ties go to the lowest
scene-order index (``torch.argmin`` returns the first minimum, as
``jnp.argmin``). A hit needs t > t_min, a non-parallel ray and the point
inside the primitive (`shaders.metal:63`).

The reference's traversal is a ``lax.while_loop`` that tests ``any(live)``
on the device every iteration. On the card the walk is the hand-written
kernel ``csrc/bvh_walk.cu`` (``nearest_hit_bvh_kernel``): one thread walks
one ray to its end and folds in the spheres, one launch a call, so nothing
is read on the host and the walk captures into a CUDA graph. Given the
live-id list of a segment (``live=(ids, count)``, the shade kernel's output),
it walks only those rays. It raises on a tensor that is not on a CUDA
device, and where the tree is deeper than its stack; it never falls back to
the plain walk. ``nearest_hit_bvh`` is the
plain walk, the CPU's path and the kernel's twin: there the test is a host
fetch, made every ``check_every`` iterations. A ray that is no longer live
keeps its state (every update is masked by ``live``), so iterations run
past the last live ray change nothing, the result does not depend on
``check_every``, and one ray walked alone to its end gives the same result. ``walk_counts`` counts the plain
walks, their iterations and the host fetches.

Every launch of the kernel adds its work to its device's counters
(``counters``, ``COUNTERS``): the rays it walked and the nodes they visited
(the plain walk's ``stats`` ``visits``), and the threads its grid started.
The buffer is made before any capture, so replayed graphs add to it too.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from .. import kernels
from ..device import check_live_list
from ..ops.vecmath import sqrt
from .scenebuf import ScenePrims

BIG = 1e30

# Iterations of the plain BVH walk between two host fetches of any(live).
# The walk is bound by its launches (~100 small ops an iteration), and a
# fetch costs less than an iteration, so 1 runs the fewest iterations. One
# plain walk of config_bvh's frame-1 rays, median of three runs on an NVIDIA
# H100 80GB HBM3 at 700 W: 40.6 ms at 1, 39.6 at 8, inside the host's noise
# (chip_smoke.py [bvh]).
CHECK_EVERY = 1
# Stack levels of a ray in the walk kernel (MM_BVH_STACK in csrc/bvh_walk.cu):
# a walk needs max_depth + 2, and the deepest named scene, config_scale's
# 64x64 maze, has a tree of depth 17.
BVH_STACK = 64

walk_counts: collections.Counter = collections.Counter()

# What every launch of the walk kernel adds to its device's counters
# (csrc/bvh_walk.cu, in its order): rays walked, nodes visited, threads
# started. The kernel adds a warp's counts to one of COUNTER_STRIPES stripes of
# 16 int64 (a 128-byte line each, MM_BVH_STRIPES), which ``counters`` sums.
COUNTERS = ("walk_rays", "walk_nodes", "walk_threads")
COUNTER_STRIPES = 32
_counters: dict = {}     # device index -> int64 [COUNTER_STRIPES, 16]


def counter_buffer(device) -> torch.Tensor:
    """The walk kernel's counters on a CUDA ``device``: allocated and zeroed
    at the first call, then the same buffer for good, which every launch on
    the device adds to (graph replays too). The first call must not be inside
    a CUDA graph capture."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    buf = _counters.get(index)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the walk's counters are allocated outside a graph capture: "
                               "launch once on the device first")
        buf = _counters[index] = torch.zeros((COUNTER_STRIPES, 16), dtype=torch.int64,
                                             device=torch.device("cuda", index))
    return buf


def counters(device) -> dict:
    """{name: count} of the walk kernel's launches on a CUDA ``device`` since
    its first or the last ``reset_counters`` (``COUNTERS``; zeros where none
    ran), with one device-to-host copy."""
    totals = counter_buffer(device)[:, :len(COUNTERS)].sum(dim=0)
    return dict(zip(COUNTERS, totals.tolist()))


def reset_counters(device) -> None:
    counter_buffer(device).zero_()


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot over the trailing axis of 3, summed left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _slab(o, inv, t_cur, bmin, bmax):
    t1 = (bmin - o) * inv
    t2 = (bmax - o) * inv
    tn = torch.minimum(t1, t2).amax(dim=-1)
    tf = torch.maximum(t1, t2).amin(dim=-1)
    hit = (tf >= tn) & (tn < t_cur) & (tf > 0.0)
    return torch.where(hit, tn, BIG)


def ray_aabb(o: torch.Tensor, d: torch.Tensor, t_cur: torch.Tensor, bmin: torch.Tensor,
             bmax: torch.Tensor) -> torch.Tensor:
    """Slab test of rays [..., 3] against boxes [..., 3]: the entry distance,
    or BIG (`shaders.metal:87-95`)."""
    return _slab(o, 1.0 / d, t_cur, bmin, bmax)


def _outer3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[R, 3] x [S, 3] -> [R, S] dots, each summed left to right."""
    return _dot3(a[:, None, :], b[None, :, :])


def sphere_ts(prims: ScenePrims, o: torch.Tensor, d: torch.Tensor, t_min: float) -> torch.Tensor:
    """Per-(ray, sphere) hit distances [R, S], BIG where missed: the near
    root of the quadratic in the reference's affine form, b = d.o - d.c and
    q = |o|^2 + (o, 1).(-2c, |c|^2 - r^2), disc = b^2 - q. Rays starting
    inside an opaque sphere pass through; a glass sphere (ior > 0) takes the
    far root -b + sqrt(disc) when the near one is not past t_min."""
    sdo = _dot3(o, d)[:, None]
    soo = _dot3(o, o)[:, None]
    c = prims.sph_center
    b = sdo - _outer3(d, c)
    q = soo + (_outer3(o, -2.0 * c) + prims.sph_c2r2[None, :])
    disc = b * b - q
    root = sqrt(torch.clamp_min(disc, 0.0))
    ts = -b - root
    ok = (disc > 0.0) & (ts > t_min)
    if prims.sph_ior is not None:
        tf = -b + root
        far_ok = (disc > 0.0) & (tf > t_min) & (prims.sph_ior > 0.0)[None, :]
        ts = torch.where(ok, ts, torch.where(far_ok, tf, ts))
        ok = ok | far_ok
    return torch.where(ok, ts, BIG)


def _merge_spheres(prims, o, d, t_min, t, idx):
    """Fold the sphere hits into a plane result; sphere i reports index
    num_planes + i. Strictly nearer wins, so a plane keeps an exact tie."""
    ts = sphere_ts(prims, o, d, t_min)
    ts_min = ts.amin(dim=-1)
    s_idx = torch.argmin(ts, dim=-1).to(torch.int32)
    better = ts_min < t
    return torch.where(better, ts_min, t), torch.where(better, prims.num_planes + s_idx, idx)


def _dense_nearest(prims, o, d, t_min, dot3):
    """All primitives against all rays, parameterized on the [R,3]x[P,3]
    product."""
    on = dot3(o, prims.normal)
    dn = dot3(d, prims.normal)
    t = (prims.d[None, :] - on) / dn
    s1 = dot3(o, prims.w1) + t * dot3(d, prims.w1) - prims.b1[None, :]
    s2 = dot3(o, prims.w2) + t * dot3(d, prims.w2) - prims.b2[None, :]
    # Quads test each edge coordinate against 1, triangles (kind 3) their
    # sum: s1, s2 are then barycentric coordinates.
    ok = (prims.valid[None, :] & (dn != 0.0) & (t > t_min) & (s1 >= 0.0) & (s2 >= 0.0)
          & torch.where(prims.is_tri[None, :], s1 + s2 <= 1.0, (s1 <= 1.0) & (s2 <= 1.0)))
    t = torch.where(ok, t, BIG)
    idx = torch.argmin(t, dim=-1).to(torch.int32)
    t = t.amin(dim=-1)
    if prims.num_spheres:
        return _merge_spheres(prims, o, d, t_min, t, idx)
    return t, idx


def nearest_hit_brute(prims: ScenePrims, o: torch.Tensor, d: torch.Tensor,
                      t_min: float) -> tuple[torch.Tensor, torch.Tensor]:
    """All-primitives nearest hit through matrix products. o, d: [R, 3] ->
    (t [R], idx [R])."""
    return _dense_nearest(prims, o, d, t_min, lambda a, b: a @ b.T)


def nearest_hit_exact(prims: ScenePrims, o: torch.Tensor, d: torch.Tensor,
                      t_min: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``nearest_hit_brute`` with each product as three explicit multiplies
    summed left to right (the reference's full-f32 backend)."""
    return _dense_nearest(prims, o, d, t_min, _outer3)


class BVHTables(NamedTuple):
    """The traversal's packed operands, built once per scene: per node both
    children's boxes and (count, left_first) as exact float32 columns [M, 14],
    and per primitive slot the whole leaf run that starts there [N, L * 15]
    (normal, d, w1, b1, w2, b2, valid, scene id, triangle flag per slot)."""

    noderow: torch.Tensor
    leafpack: torch.Tensor


def bvh_tables(prims: ScenePrims, max_leaf: int) -> BVHTables:
    m = prims.bvh_min.shape[0]
    lf = prims.bvh_left_first
    lc, rc = lf.clamp(0, m - 1), (lf + 1).clamp(0, m - 1)
    noderow = torch.cat([prims.bvh_min[lc], prims.bvh_max[lc], prims.bvh_min[rc],
                         prims.bvh_max[rc], prims.bvh_count.float()[:, None],
                         lf.float()[:, None]], dim=-1)
    pid = prims.bvh_prim
    f = lambda x: x[pid].float()[:, None]
    plane = torch.cat([prims.normal[pid], f(prims.d), prims.w1[pid], f(prims.b1),
                       prims.w2[pid], f(prims.b2), f(prims.valid), pid.float()[:, None],
                       f(prims.is_tri)], dim=-1)
    n_slots = plane.shape[0]
    # Rows past a leaf's count hold the next slots' planes (rejected by the
    # k < count mask); zero rows of padding fail valid > 0.
    plane_pad = torch.cat([plane, plane.new_zeros((max(max_leaf - 1, 0), plane.shape[1]))])
    leafpack = torch.cat([plane_pad[k:k + n_slots] for k in range(max_leaf)], dim=-1)
    return BVHTables(noderow, leafpack)


def nearest_hit_bvh(prims: ScenePrims, o: torch.Tensor, d: torch.Tensor, t_min: float,
                    max_depth: int, max_leaf: int, check_every: int = CHECK_EVERY,
                    tables: BVHTables | None = None,
                    stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Ordered stack traversal, every ray on its own path: descend the
    nearer child, push the farther one when it is also hit, test up to
    ``max_leaf`` primitives of a leaf under masks; strictly nearer hits win
    in visit order. ``tables`` are ``bvh_tables(prims, max_leaf)``, built
    here when not given. With ``stats``, the work of the rays' walks is
    added to it as int64 tensors: node ``visits``, ``interior`` visits (two
    slab tests each) and primitive ``tests``."""
    if tables is None:
        tables = bvh_tables(prims, max_leaf)
    noderow, leafpack = tables.noderow, tables.leafpack
    n_rays, n_slots = o.shape[0], leafpack.shape[0]
    inv = 1.0 / d
    dev = o.device
    t = torch.full((n_rays,), BIG, dtype=torch.float32, device=dev)
    idx = torch.zeros((n_rays,), dtype=torch.int32, device=dev)
    n_levels = max_depth + 2
    stack = torch.zeros((n_levels, n_rays), dtype=torch.int64, device=dev)
    sp = torch.zeros((n_rays,), dtype=torch.int64, device=dev)
    cur = torch.zeros((n_rays,), dtype=torch.int64, device=dev)
    live = torch.ones((n_rays,), dtype=torch.bool, device=dev)
    walk_counts["walks"] += 1
    it = 0
    while True:
        nr = noderow[cur]
        ct = nr[:, 12].long()
        lf = nr[:, 13].long()
        is_leaf = ct >= 1
        lp = leafpack[lf.clamp(0, n_slots - 1)]
        if stats is not None:
            stats["visits"] = stats.get("visits", 0) + live.sum()
            stats["interior"] = stats.get("interior", 0) + (live & ~is_leaf).sum()
            stats["tests"] = stats.get("tests", 0) + torch.where(
                live & is_leaf, ct.clamp(max=max_leaf), 0).sum()
        for k in range(max_leaf):
            pk = lp[:, 15 * k:15 * (k + 1)]
            nrm = pk[:, 0:3]
            denom = _dot3(d, nrm)
            tk = (pk[:, 3] - _dot3(o, nrm)) / denom
            x = o + tk[:, None] * d
            s1 = _dot3(x, pk[:, 4:7]) - pk[:, 7]
            s2 = _dot3(x, pk[:, 8:11]) - pk[:, 11]
            ok = ((pk[:, 12] > 0.0) & (denom != 0.0) & (tk > t_min) & (s1 >= 0.0) & (s2 >= 0.0)
                  & torch.where(pk[:, 14] > 0.0, s1 + s2 <= 1.0, (s1 <= 1.0) & (s2 <= 1.0)))
            upd = live & is_leaf & (ct > k) & ok & (tk < t)
            t = torch.where(upd, tk, t)
            idx = torch.where(upd, pk[:, 13].to(torch.int32), idx)
        # Interior: follow the near child, push the far one.
        d1 = _slab(o, inv, t, nr[:, 0:3], nr[:, 3:6])
        d2 = _slab(o, inv, t, nr[:, 6:9], nr[:, 9:12])
        first = d1 <= d2
        near = torch.where(first, lf, lf + 1)
        far = torch.where(first, lf + 1, lf)
        go_near = live & ~is_leaf & (torch.minimum(d1, d2) < BIG)
        push_far = go_near & (torch.maximum(d1, d2) < BIG)
        slot = sp.clamp(max=n_levels - 1)[None, :]
        stack.scatter_(0, slot, torch.where(push_far, far, stack.gather(0, slot)[0])[None, :])
        sp = sp + push_far.long()
        # Advance: the near child, else pop the latest far child, else done.
        can_pop = live & ~go_near & (sp > 0)
        sp = torch.where(can_pop, sp - 1, sp)
        popped = torch.where(sp < n_levels,
                             stack.gather(0, sp.clamp(0, n_levels - 1)[None, :])[0], 0)
        cur = torch.where(go_near, near, torch.where(can_pop, popped, cur))
        live = live & (go_near | can_pop)
        it += 1
        if it % check_every == 0:
            walk_counts["syncs"] += 1
            if not bool(live.any()):
                break
    walk_counts["iterations"] += it
    if prims.num_spheres:
        return _merge_spheres(prims, o, d, t_min, t, idx)
    return t, idx


def nearest_hit_bvh_kernel(prims: ScenePrims, o: torch.Tensor, d: torch.Tensor, t_min: float,
                           max_depth: int, max_leaf: int, tables: BVHTables | None = None,
                           live: tuple | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``nearest_hit_bvh`` in one launch of the ``bvh_walk`` kernel
    (csrc/bvh_walk.cu), the sphere fold included: bitwise the plain walk.
    o, d: [R, 3] float32 on a CUDA device. ``live = (ids, count)`` walks only
    the rays ``ids[:count]`` (ids int32 [R], count int32 [1], both on the
    rays' device; render/tracer.py trace_paths makes them): their t and idx
    are the plain walk's, the other rays' entries are left unwritten. The
    launch adds its work to the device's ``counters``. Raises
    where the walk needs more than ``BVH_STACK`` levels (``max_depth + 2``),
    the rays are not on a CUDA device or the list is malformed; it does not
    fall back to the plain walk."""
    n_levels = max_depth + 2
    if n_levels > BVH_STACK:
        raise ValueError(f"a BVH of depth {max_depth} needs {n_levels} stack levels, the "
                         f"bvh_walk kernel holds {BVH_STACK}")
    ids = count = None
    if live is not None:
        ids, count = live
        check_live_list(ids, count, o.shape[0], o.device)
    if o.device.type != "cuda":
        raise ValueError(f"the bvh_walk kernel runs on CUDA tensors, got {o.device}; "
                         "nearest_hit_bvh is the plain walk")
    if tables is None:
        tables = bvh_tables(prims, max_leaf)
    noderow, leafpack = tables.noderow.contiguous(), tables.leafpack.contiguous()
    if leafpack.shape[1] != 15 * max_leaf:
        raise ValueError(f"tables of {leafpack.shape[1] // 15} slots a leaf for max_leaf "
                         f"{max_leaf}")
    sph = [prims.sph_center, prims.sph_c2r2] if prims.num_spheres else []
    if sph and prims.sph_ior is not None:
        sph.append(prims.sph_ior)
    sph = [x.contiguous() for x in sph]
    for name, x in (("noderow", noderow), ("leafpack", leafpack), ("o", o), ("d", d),
                    *(("spheres", x) for x in sph)):
        if x.device != o.device or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {o.device}, got {x.dtype} on {x.device}")
    if o.ndim != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o, d must both be [R, 3], got {tuple(o.shape)}, {tuple(d.shape)}")
    o, d = o.contiguous(), d.contiguous()
    n_rays = o.shape[0]
    t = torch.empty((n_rays,), dtype=torch.float32, device=o.device)
    idx = torch.empty((n_rays,), dtype=torch.int32, device=o.device)
    ptr = lambda i: sph[i].data_ptr() if i < len(sph) else None   # noqa: E731
    with torch.cuda.device(o.device):
        kernels.launch("bvh_walk", noderow.data_ptr(), leafpack.data_ptr(), noderow.shape[0],
                       leafpack.shape[0], max_leaf, ptr(0), ptr(1), ptr(2), prims.num_spheres,
                       prims.num_planes, o.data_ptr(), d.data_ptr(), t.data_ptr(),
                       idx.data_ptr(), None if ids is None else ids.data_ptr(),
                       None if count is None else count.data_ptr(), n_rays, n_levels,
                       float(t_min), counter_buffer(o.device).data_ptr())
    return t, idx
