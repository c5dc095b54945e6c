"""The reference route ``tracer``: the plain path tracer, a frozen copy of
the port's ``render/fused_tracer.py trace_paths_plain`` for opaque quads
(the maze's planes; no spheres, glass, textures or sky), in plain torch.
The route of the configurations whose ``intersector`` is ``pallas``: the
port's fused tracer kernel.

Per ray: PCG seeded from (seed, i // B, i % B); per segment the nearest hit
over the single-tile groups tested jointly (planes tied exactly on t sum
their properties), then the walked tiles nearest first, each tested only
where the ray's slab test against its box passes nearer than its running
hit; diffuse bounce to a uniform unit vector plus the normal, mirror
reflection with its tint, the bounce and mirror limits. The arithmetic is
float32 as the program states it, or, for the benchmark's control, any
lower ``dtype``: every floating value of the trace is held in it.

With ``stats`` the work is counted as the port's plain version counts it:
``ray_segments``, ``tile_visits``, ``plane_tests``, ``edge_tests``,
``sphere_tests``, ``glass_hits``, ``textured_hits`` (the last three stay 0).
"""

from __future__ import annotations

import numpy as np
import torch

from . import scene as sc

BIG = 1e30
LANES = 128
PLAIN_BUDGET = 1 << 23
EDGE_TESTS = {0: 2, 1: 1, 2: 0}
WIDTH = 13      # normal 0:3, albedo 3:6, emission 6:9, is_mirror 9, 1/r 10, is-sphere 11, ior 12


def f32(x: float) -> float:
    return float(np.float32(x))


SINPI = tuple(f32(c) for c in (3.14159099, -5.16747237, 2.54484882, -0.56204532))
SLAB_WIDEN = f32(1e-3)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in x's dtype."""
    return torch.sqrt(x.double()).to(x.dtype)


def sinpi(t):
    c1, c2, c3, c4 = SINPI
    t2 = t * t
    return t * (c1 + t2 * (c2 + t2 * (c3 + t2 * c4)))


def pcg_scramble(state):
    state = (state * 747796405 + 291336453) & 0xFFFFFFFF
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & 0xFFFFFFFF
    return state, (word >> 22) ^ word


def pcg_init(seed, ray_ids: torch.Tensor, block_rays: int) -> torch.Tensor:
    state = (seed + (ray_ids // block_rays) * 2654435761 + (ray_ids % block_rays) * 15823) \
        & 0xFFFFFFFF
    for _ in range(2):
        _, state = pcg_scramble(state)
    return state


def tile_order(tiles: torch.Tensor, group_meta: tuple, anchor: torch.Tensor) -> list:
    """The walked tiles in walk order: group after group, within a group by
    the squared distance of the box centre from ``anchor``, nearest first
    (stable), in float32."""
    order = []
    for _, first, n in group_meta:
        if n == 1:
            continue
        box = tiles[first:first + n]
        c = (box[:, 0:3] + box[:, 3:6]) * 0.5 - anchor
        c = c * c
        d2 = (c[:, 0] + c[:, 1]) + c[:, 2]
        order += (first + torch.argsort(d2, stable=True)).tolist()
    return order


def dot3(v, w):
    return (v[:, 0:1] * w[:, 0] + v[:, 1:2] * w[:, 1]) + v[:, 2:3] * w[:, 2]


def hit_ts(mode, rows, o, d, t_min):
    pn, pd = rows[:, 0:3], rows[:, 3]
    numer = pd - dot3(o, pn)
    denom = dot3(d, pn)
    t = numer * (1.0 / denom)
    ok = t > t_min
    if mode != 2:
        w1, b1 = rows[:, 4:7], rows[:, 7]
        s1 = (dot3(o, w1) - b1) + t * dot3(d, w1)
        ok = ok & (s1 >= 0) & (1.0 - s1 >= 0)
    if mode == 0:
        w2, b2 = rows[:, 8:11], rows[:, 11]
        s2 = (dot3(o, w2) - b2) + t * dot3(d, w2)
        ok = ok & (s2 >= 0) & (1.0 - s2 >= 0)
    return torch.where(ok, t, torch.full_like(t, BIG))


def props(rows):
    pad = rows.new_zeros((rows.shape[0], 1))
    return torch.cat([rows[:, 0:3], rows[:, 12:19], pad, pad, rows[:, 19:20]], dim=1)


def dense_nearest(groups, o, d, t_min):
    tv = torch.cat([hit_ts(g[0], g[1], o, d, t_min) for g in groups], dim=1)
    tmin = tv.min(dim=1).values
    thresh = torch.where(tmin < BIG, tmin, torch.full_like(tmin, -1.0))
    onehot = (tv <= thresh[:, None]).to(o.dtype)
    return tmin, onehot @ torch.cat([g[2] for g in groups])


def slab_pass(box, o, inv_d, tmin, alive):
    t1 = (box[0:3] - o) * inv_d
    t2 = (box[3:6] - o) * inv_d
    tn = torch.minimum(t1, t2).max(dim=1).values
    tf = torch.maximum(t1, t2).min(dim=1).values
    tn = tn - tn.abs() * SLAB_WIDEN
    tf = tf + tf.abs() * SLAB_WIDEN
    return (tf >= tn) & (tf > 0.0) & (tn < tmin) & alive


def tables(planes, tiles, group_meta, anchor, dtype):
    """([(mode, records, properties)] of the single-tile groups, [(mode,
    records, properties, box)] of the walked tiles in walk order)."""
    planes, tiles_d = planes.to(dtype), tiles.to(dtype)
    rows = []
    for tile in tiles.cpu().tolist():
        first, count, mode = int(tile[6]), int(tile[7]), int(tile[8])
        if mode not in EDGE_TESTS:
            raise ValueError(f"the plain tracer here traces quads, got test mode {mode}")
        rec = planes[first:first + count]
        rows.append((mode, rec, props(rec)))
    n_single = sum(1 for g in group_meta if g[2] == 1)
    order = tile_order(tiles, group_meta, anchor)
    return rows[:n_single], [rows[ti] + (tiles_d[ti],) for ti in order]


def nearest(single, walk, o, d, t_min, alive, counts):
    if single:
        tmin, sel = dense_nearest(single, o, d, t_min)
    else:
        tmin = torch.full_like(o[:, 0], BIG)
        sel = o.new_zeros((o.shape[0], WIDTH))
    if walk:
        inv_d = torch.clamp(1.0 / d, -BIG, BIG)
    for mode, rows, prop, box in walk:
        reach = slab_pass(box, o, inv_d, tmin, alive)
        if rows.shape[0] == 0:
            continue
        if counts is not None:
            n = int(reach.sum())
            counts["tile_visits"] += n
            counts["plane_tests"] += n * rows.shape[0]
            counts["edge_tests"] += n * rows.shape[0] * EDGE_TESTS[mode]
        # Only the rays that reach the tile are tested (each ray's test is
        # its own, so this changes no value).
        idx = torch.nonzero(reach)[:, 0]
        if idx.numel() == 0:
            continue
        tile_t, tile_sel = dense_nearest([(mode, rows, prop)], o[idx], d[idx], t_min)
        better = tile_t < tmin[idx]
        tmin = tmin.index_put((idx,), torch.where(better, tile_t, tmin[idx]))
        sel = sel.index_put((idx,), torch.where(better[:, None], tile_sel, sel[idx]))
    return tmin, sel


def trace_chunk(single, walk, o, d, rng, tc: dict, counts):
    dtype = o.dtype
    t_min = f32(tc["t_min"])
    tint = f32(tc["mirror_tint"])
    tp = torch.ones_like(o)
    lt = torch.zeros_like(o)
    mh = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    dc = torch.zeros_like(mh)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    per_segment = [sum(g[1].shape[0] for g in single),
                   sum(g[1].shape[0] * EDGE_TESTS[g[0]] for g in single)]
    for _ in range(tc["bounce_limit"] + tc["mirror_limit"]):
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        if counts is not None:
            counts["ray_segments"] += n_alive
            counts["plane_tests"] += n_alive * per_segment[0]
            counts["edge_tests"] += n_alive * per_segment[1]
        t, sel = nearest(single, walk, o, d, t_min, alive, counts)
        n, c, e, mir = sel[:, 0:3], sel[:, 3:6], sel[:, 6:9], sel[:, 9]
        hit = alive & (t < BIG)
        dn = (d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1]) + d[:, 2] * n[:, 2]
        side = -torch.sign(dn)
        mirror = hit & (mir > 0.0) & (side != -1.0)
        diffuse = hit & ~mirror
        mh_new = mh + mirror.to(torch.int32)
        mirror_live = mirror & (mh_new < tc["mirror_limit"])

        rng, word = pcg_scramble(rng)
        u1 = (word & 0xFFFF).to(torch.float32).to(dtype) * (1.0 / 65536.0)
        u2 = (word >> 16).to(torch.float32).to(dtype) * (1.0 / 65536.0)
        z = u1 * 2.0 - 1.0
        x = u2 * 2.0 - 1.0
        k = torch.round(x)
        sphi = sinpi(x - k) * (1.0 - 2.0 * torch.abs(k))
        cphi = sinpi(0.5 - torch.abs(x))
        r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        u = torch.stack([r * cphi, r * sphi, z], dim=1)

        dif = diffuse[:, None]
        lt = torch.where(dif, lt + e * tp, lt)
        tp = torch.where(dif, tp * c, tp)
        lt = torch.where(mirror_live[:, None], lt + c * tint, lt)
        v = torch.where(dif, u + n * side[:, None], d - 2.0 * dn[:, None] * n)
        v_inv = 1.0 / sqrt((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2])
        o = o + d * t[:, None]
        d = v * v_inv[:, None]
        mh = mh_new
        dc = dc + diffuse.to(torch.int32)
        alive = hit & ~(mirror & (mh_new >= tc["mirror_limit"])) & (dc < tc["bounce_limit"])
    return lt


def build(cfg: dict, device) -> sc.RefScene:
    """The maze of ``cfg`` and its tables on ``device``."""
    return sc.build(cfg, device)


def trace(scene: sc.RefScene, ori, dirs, ray_ids: torch.Tensor, frames: list,
          anchor: torch.Tensor, tc: dict, dtype=torch.float32, budget: int = PLAIN_BUDGET,
          stats: dict | None = None) -> torch.Tensor:
    """The route's light [R, 3] in ``dtype`` (portbench/reference/__init__.py):
    each ray seeded from its frame's ``seed``."""
    seed = torch.cat([torch.full((n,), f.seed, dtype=torch.int64, device=ray_ids.device)
                      for f, n in frames])
    return trace_paths(scene.planes, scene.tiles, scene.group_meta, ori, dirs, seed, tc,
                       ray_ids, anchor, dtype, stats, budget).to(dtype)


def trace_paths(planes, tiles, group_meta, ori, dirs, seed, tc: dict, ray_ids: torch.Tensor,
                anchor: torch.Tensor, dtype=torch.float32, stats: dict | None = None,
                budget: int = PLAIN_BUDGET) -> torch.Tensor:
    """The light [R, 3] (float32) of rays (ori, dirs) [R, 3] at positions
    ``ray_ids`` of their frame's wavefront, under the tracer config ``tc``
    (a configuration file's ``tracer`` group), their frame's ``seed`` (one
    int, or an int64 tensor [R] for rays of many frames) and the walk
    order's ``anchor`` (the camera centre). At most ``budget`` elements of a
    [rays, planes] intermediate are held at once."""
    if tc["sky_strength"] != 0.0 or tc["noise_rng"]:
        raise ValueError("the plain tracer here has no sky term and no noise seed row")
    block = tc["block_rows"] * LANES
    single, walk = tables(planes, tiles, group_meta, anchor, dtype)
    rng = pcg_init(seed, ray_ids.to(torch.int64), block)
    widest = max([sum(g[1].shape[0] for g in single)] + [w[1].shape[0] for w in walk])
    step = max(32, budget // max(1, widest) // 32 * 32)
    counts = None
    if stats is not None:
        counts = dict.fromkeys(("ray_segments", "tile_visits", "plane_tests", "edge_tests"), 0)
    ori, dirs = ori.to(dtype), dirs.to(dtype)
    parts = [trace_chunk(single, walk, ori[i:i + step], dirs[i:i + step], rng[i:i + step], tc,
                         counts)
             for i in range(0, ori.shape[0], step)]
    if stats is not None:
        for name, n in dict(counts, sphere_tests=0, glass_hits=0, textured_hits=0).items():
            stats[name] = stats.get(name, 0) + n
    light = torch.cat(parts) if parts else torch.zeros_like(ori)
    return light.float()
