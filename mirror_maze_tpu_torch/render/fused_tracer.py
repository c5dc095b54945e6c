"""Fused path tracer (counterpart of the JAX package's
``render/pallas_tracer.py``).

``trace_paths_fused`` traces a ray wavefront through the whole bounce loop
and returns the gathered light [R, 3]. On CUDA tensors it launches the
hand-written kernel (csrc/tracer.cu, one thread per ray); on CPU tensors it
runs ``trace_paths_plain``, the same function in PyTorch, vectorized over
rays with [R, rows] intermediates and Python loops over segments and tiles.

Both reproduce the Pallas kernel as the CPU interpreter runs it, for
opaque, untextured quads of test modes 0-2 in any number of tiles, with
the noise seed row and the sky term:

- hit test: t = numer * (1/denom) with the plane constants dotted against
  (o, 1, d) left to right; the edge tests of the plane's mode,
  min(s, 1-s) >= 0; t > t_min; misses at BIG;
- the single-tile groups (scenebuf.tile_table) are tested jointly: one
  nearest t over all their planes, and planes tied exactly on it sum their
  properties (the reference's one-hot select);
- then the tiles of the multi-tile groups, group with most tiles first,
  within a group nearest tile first (``tile_order``, from the anchor, which
  is the camera). A tile's own nearest hit (ties inside it summed) replaces
  the running one only where it is strictly nearer;
- a tile is tested for a ray only if the ray's slab test against the
  tile's box passes nearer than its running hit (``_slab_pass``). The
  reference makes the same test but skips per block: a tile runs for all
  rays of a block if any of them passes. For a ray inside the closed world
  the test is conservative and the two are the same function. They differ
  on rays that leave the world (a floor or ceiling hit nearer than t_min is
  rejected, and the ray passes through): out there a wall's unbounded plane
  (test mode 1) can be hit outside its tile's box, and in the reference
  that hit counts if another ray of the block made the tile run. The port
  skips per ray, in the kernel and in the plain version, so a ray's light
  never depends on the rays beside it; ``skip=False`` gives the plain
  version that tests every tile;
- the PCG stream of ray i is seeded from (seed, i // B, i % B), B the
  reference's rays per Pallas program (``rows_per_block * 128``), plus the
  ray's ``seed_row`` value scaled to 24 bits; the image depends on B and
  never on the CUDA launch geometry;
- a live ray that misses gathers sky_color * lighting_factor^(segment -
  mirror hits) * sky_strength when ``sky_strength`` is not 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import TracerConfig
from .scenebuf import DeviceScene

BIG = 1e30
LANES = 128
MASK = 0xFFFFFFFF
PLAIN_CHUNK = 1 << 16    # most rays per pass of the plain version
PLAIN_BUDGET = 1 << 23   # most [rays, rows] elements of one intermediate


def _f32(x: float) -> float:
    """x rounded to float32 (the value the reference computes with)."""
    return float(np.float32(x))


_SINPI = tuple(_f32(c) for c in (3.14159099, -5.16747237, 2.54484882, -0.56204532))
_SLAB_WIDEN = _f32(1e-3)


def _sinpi(t: torch.Tensor) -> torch.Tensor:
    """sin(pi*t) for t in [-0.5, 0.5]: the reference's odd polynomial."""
    c1, c2, c3, c4 = _SINPI
    t2 = t * t
    return t * (c1 + t2 * (c2 + t2 * (c3 + t2 * c4)))


def _pcg_scramble(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One PCG step on uint32 values held in int64: (new state, word)."""
    state = (state * 747796405 + 291336453) & MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK
    return state, (word >> 22) ^ word


def pcg_init(seed: torch.Tensor, ray_ids: torch.Tensor, block_rays: int,
             seed_row: torch.Tensor | None = None) -> torch.Tensor:
    """Per-ray PCG state (int64 holding uint32) of the rays at positions
    ``ray_ids`` of their wavefront: seed + pid*2654435761 + r*15823 with
    pid = i // B, r = i % B, two scramble rounds, then the ray's seed-row
    value in [0, 1) added as a 24-bit integer (truncated toward zero)."""
    state = (seed.to(torch.int64).reshape(()) + (ray_ids // block_rays) * 2654435761
             + (ray_ids % block_rays) * 15823) & MASK
    for _ in range(2):
        _, state = _pcg_scramble(state)
    if seed_row is not None:
        offset = (seed_row * float(1 << 24)).to(torch.int32).to(torch.int64)
        state = (state + offset) & MASK
    return state


def tile_order(tiles: torch.Tensor, group_meta: tuple, anchor: torch.Tensor) -> torch.Tensor:
    """The walk order of the multi-tile groups' tiles, int32 indices into
    ``tiles``: group after group as they stand (most tiles first), within a
    group by squared distance of the tile box's centre from ``anchor``,
    nearest first (a stable sort, as the reference's). Empty for a scene
    whose groups are all single-tile. Runs on the tiles' device, no sync."""
    parts = []
    for _, first, n in group_meta:
        if n == 1:
            continue
        box = tiles[first:first + n]
        c = (box[:, 0:3] + box[:, 3:6]) * 0.5 - anchor
        c = c * c
        d2 = (c[:, 0] + c[:, 1]) + c[:, 2]
        parts.append(first + torch.argsort(d2, stable=True))
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=tiles.device)
    return torch.cat(parts).to(torch.int32)


def _dense_nearest(rows, o, d, t_min):
    """(t [R], sel [R, 10]) over the plane records ``rows``; sel = normal,
    albedo, emission, is_mirror of the winner (tie-summed), zeros on a
    miss."""
    pn, pd = rows[:, 0:3], rows[:, 3]
    w1, b1 = rows[:, 4:7], rows[:, 7]
    w2, b2 = rows[:, 8:11], rows[:, 11]
    mode = rows[:, 19]

    def dot3(v, w):  # [R, 3] x [P, 3] -> [R, P], x + y + z left to right
        return (v[:, 0:1] * w[:, 0] + v[:, 1:2] * w[:, 1]) + v[:, 2:3] * w[:, 2]

    numer = pd - dot3(o, pn)
    denom = dot3(d, pn)
    t = numer * (1.0 / denom)
    s1 = (dot3(o, w1) - b1) + t * dot3(d, w1)
    s2 = (dot3(o, w2) - b2) + t * dot3(d, w2)
    edge1 = ((s1 >= 0) & (1.0 - s1 >= 0)) | (mode > 1.5)
    edge2 = ((s2 >= 0) & (1.0 - s2 >= 0)) | (mode > 0.5)
    ok = (t > t_min) & edge1 & edge2
    tv = torch.where(ok, t, torch.full_like(t, BIG))
    tmin = tv.min(dim=1).values
    thresh = torch.where(tmin < BIG, tmin, torch.full_like(tmin, -1.0))
    onehot = (tv <= thresh[:, None]).to(torch.float32)
    props = torch.cat([rows[:, 0:3], rows[:, 12:19]], dim=1)   # [P, 10]
    return tmin, onehot @ props


def _slab_pass(box, o, inv_d, tmin, alive):
    """The reference's per-ray tile test: the ray enters the tile's box
    (entry and exit widened by a relative 1e-3) in front of it and nearer
    than its running hit."""
    t1 = (box[0:3] - o) * inv_d
    t2 = (box[3:6] - o) * inv_d
    tn = torch.minimum(t1, t2).max(dim=1).values
    tf = torch.maximum(t1, t2).min(dim=1).values
    tn = tn - tn.abs() * _SLAB_WIDEN
    tf = tf + tf.abs() * _SLAB_WIDEN
    return (tf >= tn) & (tf > 0.0) & (tn < tmin) & alive


def _edge_tests(rows: torch.Tensor) -> int:
    """Edge tests a hit test of each of these records makes: 2 - mode."""
    return int((2.0 - rows[:, 19]).sum())


def _plain_tables(scene: DeviceScene, anchor: torch.Tensor):
    """What a pass of the plain version reads of the scene: (the records of
    the single-tile groups joined, [(records, tile row) of each walked
    tile, in walk order])."""
    spans = [(int(t[6]), int(t[7])) for t in scene.tiles.cpu().tolist()]
    n_single = sum(1 for g in scene.group_meta if g[2] == 1)
    single = torch.cat([scene.planes[:0]] + [scene.planes[a:a + n] for a, n in spans[:n_single]])
    order = tile_order(scene.tiles, scene.group_meta, anchor).tolist()
    walk = [(scene.planes[spans[ti][0]:sum(spans[ti])], scene.tiles[ti]) for ti in order]
    return single, walk


def trace_paths_plain(
    scene: DeviceScene,
    ori: torch.Tensor,          # [R, 3]
    dirs: torch.Tensor,         # [R, 3]
    seed: torch.Tensor,         # int32, one element
    cfg: TracerConfig,
    rows_per_block: int,
    anchor: torch.Tensor | None = None,     # [3] tile-order anchor (None = origin)
    seed_row: torch.Tensor | None = None,   # [R] float32 in [0, 1)
    ray_ids: torch.Tensor | None = None,    # [R] int64 (None = 0 .. R-1)
    stats: dict | None = None,
    skip: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version of the fused tracer: light [R, 3].

    ``ray_ids`` gives each ray's position in its wavefront, which seeds its
    PCG stream: a subset of a wavefront (whole blocks of B rays, say) traced
    with its own positions gets the light it gets in the whole.

    Every tile is tested densely for every ray, a bounded number of rays at
    a time, and a tile's result is dropped for the rays whose slab test it
    fails; with ``skip=False`` it is kept, which is the tracer without any
    tile skip. With ``stats``, the work the per-ray skip leaves is added to
    it:
    ``ray_segments``, the (ray, segment) pairs traced alive;
    ``tile_visits``, the (ray, segment, tile) triples of the multi-tile
    groups whose slab test passes against the nearest hit of the tiles
    before; ``plane_tests`` and ``edge_tests``, the hit tests and edge
    tests of those tiles' planes and of the single-tile groups' planes."""
    dev = ori.device
    if anchor is None:
        anchor = torch.zeros(3, dtype=torch.float32, device=dev)
    if ray_ids is None:
        ray_ids = torch.arange(ori.shape[0], dtype=torch.int64, device=dev)
    rng = pcg_init(seed, ray_ids, rows_per_block * LANES, seed_row)
    tables = _plain_tables(scene, anchor)
    widest = max([tables[0].shape[0]] + [rows.shape[0] for rows, _ in tables[1]])
    step = max(1, min(PLAIN_CHUNK, PLAIN_BUDGET // max(1, widest)))
    parts = []
    for c0 in range(0, ori.shape[0], step):
        sl = slice(c0, c0 + step)
        parts.append(_trace_plain_chunk(tables, ori[sl], dirs[sl], rng[sl], cfg, stats, skip))
    return torch.cat(parts) if parts else torch.zeros_like(ori)


def _nearest(single, walk, o, d, t_min, alive, counts, skip):
    """Nearest hit over all groups in the reference's merge order:
    (t [R], sel [R, 10]). ``counts`` (or None) is a tensor of three sums:
    tile visits, plane tests and edge tests of the walked tiles."""
    if single.shape[0]:
        tmin, sel = _dense_nearest(single, o, d, t_min)
    else:
        tmin = torch.full_like(o[:, 0], BIG)
        sel = o.new_zeros((o.shape[0], 10))
    if walk:
        inv_d = torch.clamp(1.0 / d, -BIG, BIG)
    for rows, box in walk:
        reach = _slab_pass(box, o, inv_d, tmin, alive)
        if counts is not None:
            counts += reach.sum() * torch.tensor([1, rows.shape[0], _edge_tests(rows)],
                                                 device=counts.device)
        tile_t, tile_sel = _dense_nearest(rows, o, d, t_min)
        better = tile_t < tmin
        if skip:
            better = better & reach
        tmin = torch.where(better, tile_t, tmin)
        sel = torch.where(better[:, None], tile_sel, sel)
    return tmin, sel


def _trace_plain_chunk(tables, o, d, rng, cfg, stats, skip):
    single, walk = tables
    t_min = _f32(cfg.t_min)
    tint = _f32(cfg.mirror_tint)
    sky = cfg.sky_strength != 0.0
    if sky:
        sky_rgb = torch.tensor([_f32(c) for c in cfg.sky_color], device=o.device)
    tp = torch.ones_like(o)                         # throughput rgb
    lt = torch.zeros_like(o)                        # gathered light rgb
    mh = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    dc = torch.zeros_like(mh)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    counts = None
    if stats is not None:
        counts = torch.zeros(3, dtype=torch.int64, device=o.device)
        n_single = single.shape[0]
        e_single = _edge_tests(single)
    for seg in range(cfg.max_segments):
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        if stats is not None:
            for name, n in (("ray_segments", 1), ("plane_tests", n_single),
                            ("edge_tests", e_single)):
                stats[name] = stats.get(name, 0) + n_alive * n
        t, sel = _nearest(single, walk, o, d, t_min, alive, counts, skip)
        n, c, e, mir = sel[:, 0:3], sel[:, 3:6], sel[:, 6:9], sel[:, 9]
        hit = alive & (t < BIG)
        if sky:
            # lighting_factor^(segment - mirror hits), with 0^0 = 1.
            expo = (seg - mh).to(torch.float32)
            if cfg.lighting_factor > 0.0:
                fac = torch.exp(expo * _f32(np.log(cfg.lighting_factor))) * _f32(cfg.sky_strength)
            else:
                fac = torch.where(expo == 0.0, _f32(cfg.sky_strength), 0.0)
            lt = torch.where((alive & ~hit)[:, None], lt + sky_rgb * fac[:, None], lt)
        dn = (d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1]) + d[:, 2] * n[:, 2]
        side = -torch.sign(dn)
        mirror = hit & (mir > 0.0) & (side != -1.0)
        diffuse = hit & ~mirror
        mh_new = mh + mirror.to(torch.int32)
        mirror_live = mirror & (mh_new < cfg.mirror_limit)

        rng, word = _pcg_scramble(rng)
        u1 = (word & 0xFFFF).to(torch.float32) * (1.0 / 65536.0)
        u2 = (word >> 16).to(torch.float32) * (1.0 / 65536.0)
        z = u1 * 2.0 - 1.0
        x = u2 * 2.0 - 1.0
        k = torch.round(x)
        sphi = _sinpi(x - k) * (1.0 - 2.0 * torch.abs(k))
        cphi = _sinpi(0.5 - torch.abs(x))
        r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        u = torch.stack([r * cphi, r * sphi, z], dim=1)

        dif = diffuse[:, None]
        lt = torch.where(dif, lt + e * tp, lt)
        tp = torch.where(dif, tp * c, tp)
        lt = torch.where(mirror_live[:, None], lt + c * tint, lt)
        v = torch.where(dif, u + n * side[:, None], d - 2.0 * dn[:, None] * n)
        v_inv = 1.0 / torch.sqrt((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2])
        o = o + d * t[:, None]
        d = v * v_inv[:, None]
        mh = mh_new
        dc = dc + diffuse.to(torch.int32)
        alive = hit & ~(mirror & (mh_new >= cfg.mirror_limit)) & (dc < cfg.bounce_limit)
    if stats is not None:
        for name, n in zip(("tile_visits", "plane_tests", "edge_tests"), counts.tolist()):
            stats[name] = stats.get(name, 0) + n
    return lt


def trace_paths_fused(
    scene: DeviceScene,
    ori: torch.Tensor,          # [R, 3] float32
    dirs: torch.Tensor,         # [R, 3] float32
    seed: torch.Tensor,         # int32, one element, on the rays' device
    cfg: TracerConfig,
    rows_per_block: int,
    anchor: torch.Tensor | None = None,     # [3] float32 tile-order anchor (None = origin)
    seed_row: torch.Tensor | None = None,   # [R] float32 in [0, 1), mixed into the seeds
) -> torch.Tensor:
    """Trace a ray wavefront; returns light [R, 3]. The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    dev = ori.device
    planes, tiles = scene.planes, scene.tiles
    if anchor is None:
        anchor = torch.zeros(3, dtype=torch.float32, device=dev)
    checked = [("planes", planes, torch.float32), ("tiles", tiles, torch.float32),
               ("ori", ori, torch.float32), ("dirs", dirs, torch.float32),
               ("seed", seed, torch.int32), ("anchor", anchor, torch.float32)]
    if seed_row is not None:
        checked.append(("seed_row", seed_row, torch.float32))
    for name, x, dtype in checked:
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got {x.dtype} on {x.device}")
    if ori.ndim != 2 or ori.shape[1] != 3 or dirs.shape != ori.shape:
        raise ValueError(f"ori/dirs must both be [R, 3], got {tuple(ori.shape)}, {tuple(dirs.shape)}")
    if planes.ndim != 2 or planes.shape[1] != 20 or tiles.ndim != 2 or tiles.shape[1] != 8:
        raise ValueError("the scene must hold [P, 20] plane records and an [T, 8] tile table")
    if sum(g[2] for g in scene.group_meta) != tiles.shape[0]:
        raise ValueError("group_meta must account for every tile")
    if seed.numel() != 1:
        raise ValueError("seed must hold one int32")
    if anchor.shape != (3,):
        raise ValueError(f"anchor must be [3], got {tuple(anchor.shape)}")
    if seed_row is not None and seed_row.shape != ori.shape[:1]:
        raise ValueError(f"seed_row must be [R], got {tuple(seed_row.shape)}")
    if dev.type == "cpu":
        return trace_paths_plain(scene, ori, dirs, seed, cfg, rows_per_block,
                                 anchor=anchor, seed_row=seed_row)
    if dev.type != "cuda":
        raise ValueError(f"trace_paths_fused runs on cuda or cpu tensors, got {dev}")
    order = tile_order(tiles, scene.group_meta, anchor)
    ori, dirs, planes, tiles, seed = (x.contiguous() for x in (ori, dirs, planes, tiles, seed))
    if seed_row is not None:
        seed_row = seed_row.contiguous()
    light = torch.empty_like(ori)
    lf = cfg.lighting_factor
    kernels.launch(
        "tracer", ori.data_ptr(), dirs.data_ptr(), planes.data_ptr(), planes.shape[0],
        tiles.data_ptr(), tiles.shape[0], tiles.shape[0] - order.shape[0], order.data_ptr(),
        seed.data_ptr(), seed_row.data_ptr() if seed_row is not None else None,
        light.data_ptr(), ori.shape[0], rows_per_block * LANES,
        cfg.max_segments, cfg.bounce_limit, cfg.mirror_limit,
        _f32(cfg.mirror_tint), _f32(cfg.t_min),
        *(_f32(c) for c in cfg.sky_color), _f32(cfg.sky_strength), _f32(lf),
        _f32(np.log(lf)) if lf > 0.0 else 0.0,
    )
    return light
