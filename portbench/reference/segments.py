"""The reference route ``segments``: the upstream renderer's bounce loop with
its BVH walk, one segment at a time, in plain torch. The route of the
configurations whose ``intersector`` is ``bvh``: the port's segment loop
(the ``bvh_walk``, normal-draw ``threefry`` and ``shade`` kernels).

Written from the upstream's description (thebasilisk/mirror-maze
``shaders.metal``):

- the walk, ``intersect_bvh_iterative`` (115-156): an ordered stack walk from
  the root of the SAH BVH (``main.rs:74-263``, built by ``bvh.py``). At an
  interior node both children's boxes are slab-tested against the ray's
  running hit; the nearer child (the left one where the entry distances tie)
  is descended into and the farther one pushed where it is hit too; at a
  leaf each of its primitives is tested in order, and a hit replaces the
  running one only where strictly nearer; a leaf or a missed node pops the
  latest pushed node, an empty stack ends the walk. A hit needs t > t_min,
  a ray not parallel to the plane and the point inside the quad (63);
- the shading (306-339): the side of a hit is -sign(d.n); a diffuse surface
  or the back face of a mirror adds emission.rgb * strength * throughput,
  multiplies the throughput by the albedo and scatters along the side's
  normal plus a random unit vector; a mirror's front face adds albedo *
  ``mirror_tint`` and reflects while the mirror hits stay under
  ``mirror_limit``, and ends the path at it; a miss adds sky *
  lighting_factor^(segment - mirror hits) * sky_strength and ends the path;
  the loop runs while ``n < bounce_limit + mirror_hits``.

Departures from the upstream, each for the port's reason, which this route
shares since it decides what the port must give:

- the random unit vector is a normal triple over its length (the squared
  length summed as fma(z, z, fma(y, y, x * x)), each rounded once from
  float64), where the upstream rejection-samples a cube with its PCG
  stream: segment ``it`` of a frame draws ``normal(fold_in(tkey, it), (R,
  3))`` over the frame's whole wavefront of R rays, jax.random's threefry
  (``prng.py``) with its normal, sqrt(2) * erf_inv(u) for u uniform on
  [nextafter(-1, 0), 1), erf_inv as XLA's float32 Giles polynomials written
  out below; a ray at position i of the wavefront takes the triple at i;
- the quad's inside test is the exact dual basis of its edges (0 <= x.w - b
  <= 1, ``builder.py``), the same region as the upstream's edge projections
  on the maze's rectangles; the hit point is o + t d and t a true division;
- the node boxes grow over a quad's four corners (``bvh.py``), the same
  boxes as the upstream's three on the maze's axis-aligned quads; the stack
  holds the built tree's depth + 2 levels where the upstream's holds 50;
- the loop is a fixed ``bounce_limit + mirror_limit`` segments, each ray
  alive until its own rule ends it, so a path is the upstream's;
- every ray of a segment walks at once, one node visit an iteration, the
  rays whose walk has ended dropped from the next: each ray visits its
  nodes in the upstream's order, so its hit is the upstream's, ties
  included.

The arithmetic is float32 as the configurations state it (dots summed left
to right; ``trace`` turns TF32 off), or, for the benchmark's control, any lower ``dtype``: every
floating value of the trace (the scene's rows, the walk, the draws once
made, the path state) is held in it.

With ``stats`` the work is counted as the port's walk kernel counts it
(``walk_rays``, ``walk_nodes``: the nodes the walks visited) and, per
segment, ``alive`` (the rays walked), ``visits``, ``slab_tests`` (two an
interior visit), ``prim_tests`` (a leaf's primitives at each visit),
``hits``, ``diffuse`` and ``kept`` (alive after the shading); ``rays``
counts the rays traced.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prng
from . import scene as sc
from .builder import build_scene
from .bvh import build_bvh, traversal_bounds

BIG = 1e30
PLAIN_BUDGET = 1 << 23
PER_SEGMENT = ("alive", "visits", "slab_tests", "prim_tests", "hits", "diffuse", "kept")


def f32(x: float) -> float:
    return float(np.float32(x))


# XLA's float32 erf_inv (Giles) and the log1p and log it is built on, as
# XLA-CPU emits them: the constants rounded to float32.
ERFINV_LT_5 = tuple(f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
ERFINV_GE_5 = tuple(f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
LOG1P_DEN = tuple(f32(c) for c in (15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
                                   60.11866))
LOG1P_NUM = tuple(f32(c) for c in (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
                                   57.112965, 20.039553))
LOG_POLY = tuple(f32(c) for c in (0.070376836, -0.1151461, 0.116769984, -0.12420141,
                                  0.14249323, -0.16668057, 0.20000714, -0.24999994, 0.3333333))
LOG1P_SMALL, LOG_Q1, LOG_Q2 = f32(0.41421357), f32(-0.00021219444), f32(0.693359375)
SQRT_HALF, F32_MIN, SQRT2 = f32(0.70710677), f32(1.1754944e-38), f32(np.sqrt(2.0))
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in x's dtype."""
    return torch.sqrt(x.double()).to(x.dtype)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in float64, rounded once to a's dtype."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).to(a.dtype)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 log of x > 0: x = m 2^e with m in [sqrt(1/2), sqrt(2)),
    Cephes' polynomial in m - 1, ln 2 split in two."""
    x = torch.clamp_min(x, F32_MIN)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < SQRT_HALF
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    z = m * m
    m3 = z * m
    c = LOG_POLY
    y1 = fma(fma(m, c[0], c[1]), m, c[2])
    y2 = fma(fma(m, c[3], c[4]), m, c[5])
    y3 = fma(fma(m, c[6], c[7]), m, c[8])
    y = fma(fma(y1, m3, y2), m3, y3)
    y = fma(y, m3, e * LOG_Q1)
    return fma(e, LOG_Q2, (m - z * 0.5) + y)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p of x > -1: a rational function where |x| < sqrt(2) - 1,
    else log(1 + x)."""
    x2 = x * x
    den = x + LOG1P_DEN[0]
    for c in LOG1P_DEN[1:]:
        den = fma(den, x, c)
    num = torch.full_like(x, LOG1P_NUM[0])
    for c in LOG1P_NUM[1:]:
        num = fma(num, x, c)
    small = x + (x2 * -0.5 + (x * x2) * (num / den))
    return torch.where(x.abs() < LOG1P_SMALL, small, log_f32(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf_inv for |x| <= 1: Giles' polynomial in w - 2.5 (w < 5) or
    sqrt(w) - 3, w = -log1p(-x^2), times x."""
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    coef = [torch.where(lt, torch.tensor(a, dtype=torch.float64, device=x.device),
                        torch.tensor(b, dtype=torch.float64, device=x.device))
            for a, b in zip(ERFINV_LT_5, ERFINV_GE_5)]
    p = coef[0].float()
    for c in coef[1:]:
        p = fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normals(keys: tuple, ray_ids: torch.Tensor) -> torch.Tensor:
    """The normal triples [n, 3] (float32) at wavefront positions ``ray_ids``
    of draws of shape (R, 3): element (i, c) is the draw's word 3 i + c.
    ``keys`` is a key pair of ints, or of int64 tensors [n] (one key a ray)."""
    index = ray_ids.to(torch.int64)[:, None] * 3 + torch.arange(3, device=ray_ids.device)
    k1, k2 = keys
    if isinstance(k1, torch.Tensor):
        k1, k2 = k1[:, None], k2[:, None]
    return erf_inv(prng.uniform((k1, k2), index, NORMAL_LO, 1.0, torch.float32)) * SQRT2


class SegScene(NamedTuple):
    """The maze in scene order (plane i is row i; invalid planes are never
    hit) and its BVH, on the device."""
    normal: torch.Tensor      # [N, 3]
    d: torch.Tensor           # [N]
    w1: torch.Tensor          # [N, 3]
    b1: torch.Tensor          # [N]
    w2: torch.Tensor          # [N, 3]
    b2: torch.Tensor          # [N]
    color: torch.Tensor       # [N, 3]
    emission: torch.Tensor    # [N, 4] rgb, strength
    is_mirror: torch.Tensor   # [N] bool
    valid: torch.Tensor       # [N] bool
    node_min: torch.Tensor    # [M, 3]
    node_max: torch.Tensor    # [M, 3]
    left_first: torch.Tensor  # [M] int64: left child (interior), first slot (leaf)
    count: torch.Tensor       # [M] int64: 0 interior, else the leaf's primitives
    prim: torch.Tensor        # [N] int64: slot -> plane
    levels: int               # stack levels a walk needs: depth + 2
    leaf_min: np.ndarray      # [L, 3] float32 collision boxes
    leaf_max: np.ndarray


def build(cfg: dict, device) -> SegScene:
    """The maze of ``cfg`` (its own seed), its SAH BVH and the collision
    boxes, on ``device``."""
    if cfg["maze"]["glass_prob"] != 0.0:
        raise ValueError("the segments route traces opaque mazes only")
    scene = build_scene(sc.maze_section(cfg))
    der = scene.derived()
    tree = build_bvh(scene.origin, scene.u, scene.v)
    depth, _ = traversal_bounds(tree.left_first, tree.count)
    leaf_min, leaf_max = tree.leaf_boxes()
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    i = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)  # noqa: E731
    b = lambda a: torch.from_numpy(np.asarray(a, bool).copy()).to(device)  # noqa: E731
    return SegScene(normal=f(der.normal), d=f(der.d), w1=f(der.w1), b1=f(der.b1),
                    w2=f(der.w2), b2=f(der.b2), color=f(der.color), emission=f(der.emission),
                    is_mirror=b(der.is_mirror), valid=b(der.valid), node_min=f(tree.aabb_min),
                    node_max=f(tree.aabb_max), left_first=i(tree.left_first),
                    count=i(tree.count), prim=i(tree.prim_index), levels=depth + 2,
                    leaf_min=np.asarray(leaf_min, np.float32),
                    leaf_max=np.asarray(leaf_max, np.float32))


def in_dtype(s: SegScene, dtype) -> SegScene:
    """The scene's floating rows in ``dtype``."""
    return s._replace(**{k: getattr(s, k).to(dtype) for k in (
        "normal", "d", "w1", "b1", "w2", "b2", "color", "emission", "node_min", "node_max")})


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def slab(o, inv, t_cur, lo, hi) -> torch.Tensor:
    """The ray's entry distance into the boxes (lo, hi) [n, 3], or BIG where
    it misses them, they lie behind it or no nearer than ``t_cur``; a NaN
    among the six distances (0 * inf) is a miss."""
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    near = torch.minimum(t1, t2)
    far = torch.maximum(t1, t2)
    tn = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    tf = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    nan = (torch.isnan(t1) | torch.isnan(t2)).any(dim=1)
    hit = ~nan & (tf >= tn) & (tn < t_cur) & (tf > 0.0)
    return torch.where(hit, tn, torch.full_like(tn, BIG))


def walk(s: SegScene, o: torch.Tensor, d: torch.Tensor, t_min: float,
         counts: dict | None = None) -> tuple:
    """(t [n], plane [n] int64) of the nearest hit of each ray (o, d) [n, 3]
    by the ordered stack walk; t = BIG and plane 0 where it hits nothing."""
    n, dev = o.shape[0], o.device
    t = torch.full((n,), BIG, dtype=o.dtype, device=dev)
    plane = torch.zeros((n,), dtype=torch.int64, device=dev)
    inv = 1.0 / d
    stack = torch.zeros((n, s.levels), dtype=torch.int64, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    cur = torch.zeros((n,), dtype=torch.int64, device=dev)
    rays = torch.arange(n, device=dev)       # the rays whose walk goes on
    n_slots = s.prim.shape[0]
    for _ in range(s.count.shape[0]):        # a walk visits each node at most once
        if rays.numel() == 0:
            break
        node = cur[rays]
        if counts is not None:
            counts["visits"] += rays.numel()
        ct, lf = s.count[node], s.left_first[node]
        leaf = ct >= 1
        ends = leaf.clone()                  # pop or stop: a leaf, or a missed node
        at = rays[leaf]
        if at.numel():
            ro, rd, rt, rp = o[at], d[at], t[at], plane[at]
            lct, llf = ct[leaf], lf[leaf]
            for k in range(int(lct.max())):
                p = s.prim[torch.clamp(llf + k, max=n_slots - 1)]
                nrm = s.normal[p]
                denom = dot3(rd, nrm)
                tk = (s.d[p] - dot3(ro, nrm)) / denom
                x = ro + tk[:, None] * rd
                s1 = dot3(x, s.w1[p]) - s.b1[p]
                s2 = dot3(x, s.w2[p]) - s.b2[p]
                ok = (s.valid[p] & (lct > k) & (denom != 0.0) & (tk > t_min) & (s1 >= 0.0)
                      & (s2 >= 0.0) & (s1 <= 1.0) & (s2 <= 1.0) & (tk < rt))
                rt = torch.where(ok, tk, rt)
                rp = torch.where(ok, p, rp)
            t[at], plane[at] = rt, rp
            if counts is not None:
                counts["prim_tests"] += int(lct.sum())
        inner = ~leaf
        at = rays[inner]
        if at.numel():
            ro, ri, rt = o[at], inv[at], t[at]
            left = lf[inner]
            d1 = slab(ro, ri, rt, s.node_min[left], s.node_max[left])
            d2 = slab(ro, ri, rt, s.node_min[left + 1], s.node_max[left + 1])
            first = d1 <= d2
            go = torch.minimum(d1, d2) < BIG
            push = go & (torch.maximum(d1, d2) < BIG)
            far = torch.where(first, left + 1, left)
            pushed = at[push]
            stack[pushed, sp[pushed]] = far[push]
            sp[pushed] += 1
            cur[at[go]] = torch.where(first, left, left + 1)[go]
            ends[inner] = ~go
            if counts is not None:
                counts["slab_tests"] += 2 * at.numel()
        done = rays[ends]
        popped = sp[done] > 0
        pops = done[popped]
        sp[pops] -= 1
        cur[pops] = stack[pops, sp[pops]]
        keep = ~ends
        keep[ends] = popped
        rays = rays[keep]
    return t, plane


def shade(s: SegScene, tc: dict, it: int, t, plane, g, o, d, thr, light, mh, dc) -> tuple:
    """Segment ``it``'s shading of alive rays from their hits (t, plane) and
    normal triples g: (o, d, thr, light, mh, dc, alive) after it."""
    hit = t < BIG
    n, albedo = s.normal[plane], s.color[plane]
    em, mir = s.emission[plane], s.is_mirror[plane]
    side = -torch.sign(dot3(d, n))
    diffuse = hit & (~mir | (side == -1.0))
    mirror = hit & mir & (side != -1.0)
    mh_new = mh + mirror.to(torch.int32)
    mirror_live = mirror & (mh_new < tc["mirror_limit"])
    sq = fma(g[:, 2], g[:, 2], fma(g[:, 1], g[:, 1], g[:, 0] * g[:, 0]))
    rnd = g / torch.clamp_min(sqrt(sq), 1e-12)[:, None]
    scat = rnd + n * side[:, None]
    scat = scat / sqrt(dot3(scat, scat))[:, None]
    dif = diffuse[:, None]
    light = torch.where(dif, light + em[:, :3] * em[:, 3:4] * thr, light)
    thr = torch.where(dif, thr * albedo, thr)
    light = torch.where(mirror_live[:, None], light + albedo * f32(tc["mirror_tint"]), light)
    refl = d - 2.0 * dot3(d, n)[:, None] * n
    refl = refl / sqrt(dot3(refl, refl))[:, None]
    fall = torch.pow(f32(tc["lighting_factor"]), (it - mh).to(torch.float32)).to(t.dtype)
    sky = torch.tensor(tc["sky_color"], dtype=torch.float32, device=t.device).to(t.dtype)
    sky_term = sky * fall[:, None] * f32(tc["sky_strength"])
    light = torch.where(~hit[:, None], light + sky_term, light)
    o = torch.where((diffuse | mirror_live)[:, None], o + d * t[:, None], o)
    d = torch.where(dif, scat, torch.where(mirror_live[:, None], refl, d))
    dc = dc + diffuse.to(torch.int32)
    alive = hit & ~(mirror & (mh_new >= tc["mirror_limit"])) & (dc < tc["bounce_limit"])
    return o, d, thr, light, mh_new, dc, alive, diffuse


def trace_chunk(s: SegScene, o, d, ray_ids, keys, tc: dict, dtype, counts) -> torch.Tensor:
    """The light [n, 3] of rays (o, d) at wavefront positions ``ray_ids``
    whose frames' tracer keys are ``keys`` (two int64 tensors [n])."""
    n, dev = o.shape[0], o.device
    light = torch.zeros((n, 3), dtype=dtype, device=dev)
    live = torch.arange(n, device=dev)
    thr = torch.ones((n, 3), dtype=dtype, device=dev)
    mh = torch.zeros((n,), dtype=torch.int32, device=dev)
    dc = torch.zeros_like(mh)
    k1, k2 = keys
    for it in range(tc["bounce_limit"] + tc["mirror_limit"]):
        if live.numel() == 0:
            break
        walked = dict(visits=0, slab_tests=0, prim_tests=0)
        t, plane = walk(s, o[live], d[live], f32(tc["t_min"]), walked)
        g = normals(fold_in(k1[live], k2[live], it), ray_ids[live]).to(dtype)
        state = shade(s, tc, it, t, plane, g, o[live], d[live], thr[live], light[live],
                      mh[live], dc[live])
        o[live], d[live], thr[live], light[live], mh[live], dc[live] = state[:6]
        alive, diffuse = state[6], state[7]
        if counts is not None:
            for name, v in (("alive", live.numel()), ("visits", walked["visits"]),
                            ("slab_tests", walked["slab_tests"]),
                            ("prim_tests", walked["prim_tests"]),
                            ("hits", int((t < BIG).sum())), ("diffuse", int(diffuse.sum())),
                            ("kept", int(alive.sum()))):
                counts[name][it] += v
        live = live[alive]
    return light


def fold_in(k1: torch.Tensor, k2: torch.Tensor, data: int) -> tuple:
    """fold_in of per-ray keys (two int64 tensors of uint32 words) by
    ``data``."""
    return prng.threefry(k1, k2, torch.zeros_like(k1), torch.full_like(k1, data & prng.MASK))


def trace(scene: SegScene, ori, dirs, ray_ids: torch.Tensor, frames: list,
          anchor: torch.Tensor, tc: dict, dtype=torch.float32, budget: int = PLAIN_BUDGET,
          stats: dict | None = None) -> torch.Tensor:
    """The route's light [R, 3] in ``dtype`` (portbench/reference/__init__.py):
    each frame's rays draw from its ``tkey``; ``anchor`` is not read (the
    walk's order is the tree's)."""
    if tc["noise_rng"]:
        raise ValueError("the segments route has no noise seed row")
    # Float32 stays float32 on the card: no product of the trace may run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = ray_ids.device
    k1 = torch.cat([torch.full((n,), f.tkey[0], dtype=torch.int64, device=dev)
                    for f, n in frames])
    k2 = torch.cat([torch.full((n,), f.tkey[1], dtype=torch.int64, device=dev)
                    for f, n in frames])
    s = in_dtype(scene, dtype)
    ori, dirs = ori.to(dtype), dirs.to(dtype)
    segments = tc["bounce_limit"] + tc["mirror_limit"]
    counts = None
    if stats is not None:
        counts = {k: [0] * segments for k in PER_SEGMENT}
    step = max(32, budget // max(1, s.levels) // 32 * 32)
    parts = [trace_chunk(s, ori[i:i + step].clone(), dirs[i:i + step].clone(),
                         ray_ids[i:i + step], (k1[i:i + step], k2[i:i + step]), tc, dtype,
                         counts)
             for i in range(0, ori.shape[0], step)]
    if stats is not None:
        for k, v in counts.items():
            stats[k] = [a + b for a, b in zip(stats.get(k, [0] * segments), v)]
        for k, v in (("walk_rays", sum(counts["alive"])), ("walk_nodes", sum(counts["visits"])),
                     ("rays", ori.shape[0])):
            stats[k] = stats.get(k, 0) + v
    light = torch.cat(parts) if parts else torch.zeros_like(ori)
    return light.to(dtype)
