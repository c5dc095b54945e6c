"""Fused path tracer (counterpart of the JAX package's
``render/pallas_tracer.py``).

``trace_paths_fused`` traces a ray wavefront through the whole bounce loop
and returns the gathered light [R, 3]. On CUDA tensors it launches the
hand-written kernel (csrc/tracer.cu: a persistent grid whose warps refill
the lanes of rays that died, the scene in shared memory where it fits the
shared memory a block of the card may have, walked tiles that few lanes
reach tested by the whole warp); on CPU tensors it runs
``trace_paths_plain``, the same function in PyTorch, vectorized over rays
with [R, rows] intermediates and Python loops over segments and tiles.

Both reproduce the Pallas kernel as the CPU interpreter runs it, for
quads, triangles and spheres, opaque or glass (the reference's eight test
modes, scenebuf.py), plain or with a checker texture, in any number of tiles,
with the noise seed row, the sky term and the per-block diagnostics:

- plane hit test: t = numer * (1/denom) with the plane constants dotted
  against (o, 1, d) left to right; the edge tests of the mode: min(s, 1-s)
  >= 0 per tested edge of a quad, min(s1, s2, 1 - (s1 + s2)) >= 0 for a
  triangle; t > t_min; misses at BIG;
- sphere hit test: bq = D.O - D.c, q = |O|^2 + (|c|^2 - r^2 - 2 O.c),
  disc = bq*bq - q, t = -bq - sqrt(max(disc, 0)), accepted when disc > 0
  and t > t_min; a glass sphere takes -bq + sqrt(...) when the near root is
  not past t_min (the ray is inside). A sphere that wins carries its centre
  where a plane carries its normal, and the normal is rebuilt after the
  select as ((o + d t) - c) / r;
- the dielectric stage, only in a scene that has a glass group: a glass
  hit is neither mirror nor diffuse and counts against the mirror budget;
  Snell refraction on the unit direction, total internal reflection, and
  with ``cfg.fresnel`` the Schlick split decided by a third uniform, drawn
  after the scatter pair by every live ray on every segment of such a
  scene (with it off, nothing is drawn and only TIR reflects); throughput
  times albedo while under budget;
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
  mirror hits) * sky_strength when ``sky_strength`` is not 0;
- the texture stage, only in a scene that has a textured primitive
  (``scene.textured``): after the nearest hit and the sphere normal, the
  winner's albedo is swapped for its ``tex_color2`` on the odd cells of a
  checker, before any use of the albedo. With h = o + d t, kind 1 (UV
  checker) counts floor(s1 scale) + floor(s2 scale) from the winner's edge
  coordinates s = (h.w) - b, kind 2 (world checker) floor(hx / scale) +
  floor(hy / scale) + floor(hz / scale), a true division. The texture
  parameters and w1, b1, w2, b2 ride the winner like its other properties,
  so primitives tied exactly on t sum them too, and ``kind > 1.5`` / ``kind
  > 0`` select on the summed value;
- ``return_block_segments=True`` also returns the reference kernel's output
  rows 3-7, [5, ceil(R / B)] int32, per block of B rays (ray i belongs to
  block i // B, whatever the CUDA launch geometry): the segments the block
  ran (the most any of its rays lived), the tiles evaluated over them, on
  the primary segment and on segments 0-2, and the sum over segments of the
  live rays entering each. The reference evaluates a tile for a whole block
  when any live ray of it passes the tile's slab test, and the single-tile
  groups once per segment; with the per-ray skip here the vote comes to the
  same count except through rays that have left the world (their running
  nearest hit may differ). The wavefront is padded to whole blocks with
  zero rays as the reference pads it: they live one segment and vote too.

Every CUDA launch adds what it did to its device's counters (``counters``,
``COUNTERS``): live ray-segments and warp-segments, record tests issued in
lane slots against those the live rays reaching each tile need, and of the
issued ones the axis records' two-term tests. The plain version adds nothing
there; its ``stats`` count ``ray_segments`` and the tests (``plane_tests +
sphere_tests``) as ``tests_needed`` counts them, and ``axis_tests``, the
needed tests of axis records.

On the card, a scan (the single-tile groups together, or a walked tile) of a
scene without triangles or spheres, with at least scenebuf.AXIS_MIN_RECORDS
axis records (quads whose normal and tested edges each lie along one axis,
as every wall, floor and boundary of a maze does; scenebuf.py
``axis_tables``) takes the axis route: pass 1 tests
its records in an exact two-term form, sorted by axis class, and keeps the
nearest t and its record; the ray's own lane takes that record as the scan
takes a nearer one, or where records tie on it, scans again in record order
with the general test, so ties sum as the sequential scan sums them and the
light is the same bit for bit. Where t_min <= 0, a ray's o or d is not
finite, or no scan of the scene takes the route, the kernel takes the
general scan.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from .. import kernels
from ..config import TracerConfig
from ..ops.vecmath import sqrt
from .scenebuf import (
    AXIS_RUN_WIDTH,
    AXIS_TILE_WIDTH,
    SPHERE_MODES,
    SPHERE_RECORD_WIDTH,
    TEX_WIDTH,
    TILE_WIDTH,
    DeviceScene,
)

BIG = 1e30
LANES = 128
WARP = 32                # lanes of a CUDA warp (the plain version's warp statistics)
MASK = 0xFFFFFFFF
PLAIN_CHUNK = 1 << 16    # most rays per pass of the plain version
PLAIN_BUDGET = 1 << 23   # most [rays, rows] elements of one intermediate
EDGE_TESTS = {0: 2, 1: 1, 2: 0, 4: 2, 6: 2, 7: 2}   # per plane test, by mode
# The winner's selected properties (tie-summed): normal (a sphere's centre)
# 0:3, albedo 3:6, emission 6:9, is_mirror 9, 1/r 10, is-sphere 11, ior 12;
# in a textured scene also tex_kind 13, tex_scale 14, tex_color2 15:18,
# w1 18:21, b1 21, w2 22:25, b2 25 (zeros for a sphere).
SEL_WIDTH = 13
TEX_SEL_WIDTH = 26
DIAG_ROWS = 5
GEOMETRY = ("blocks", "threads", "smem", "registers", "per_sm", "resident", "axis")
# The kernel's two work counters per (device, stream), zeroed once; each
# launch leaves its pair zeroed (csrc/tracer.cu Params::work). A CUDA graph
# capture brings its own pair (``work_counters``): a graph replays on
# whatever stream is current, so its pair cannot be the capture stream's.
_work: dict = {}
_graph_work: list = []
# What every launch adds to its device's counters (csrc/tracer.cu Count, in
# its order); a record test is one plane or sphere record tested for a ray.
COUNTERS = ("ray_segments", "warp_segments", "tests_issued", "tests_needed", "axis_tests")
# Shared bytes a block keeps the counts of its warps in (32 warps of COUNTERS
# 64-bit words, csrc/tracer.cu warp_counts), beside the scene it stages.
COUNT_BYTES = 32 * len(COUNTERS) * 8
_counters: dict = {}     # device index -> int64 [len(COUNTERS)]


@contextlib.contextmanager
def work_counters(pair: torch.Tensor):
    """Launches made inside use ``pair`` (two zeroed int32 on the launch's
    device, allocated before a capture) as their work counters: the pair of
    one graph runner (runtime/graph.py), whose replays run one after
    another, each leaving the pair zeroed."""
    if pair.dtype != torch.int32 or pair.shape != (2,):
        raise ValueError(f"work counters are two int32, got {pair.dtype} {tuple(pair.shape)}")
    _graph_work.append(pair)
    try:
        yield
    finally:
        _graph_work.pop()


def counter_buffer(device) -> torch.Tensor:
    """The tracer's counters on a CUDA ``device``: allocated and zeroed at
    the first call, then the same buffer for good, which every launch on the
    device adds to (graph replays too). The first call must not be inside a
    CUDA graph capture."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    buf = _counters.get(index)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the tracer's counters are allocated outside a graph capture: "
                               "launch once on the device first")
        buf = _counters[index] = torch.zeros(len(COUNTERS), dtype=torch.int64,
                                             device=torch.device("cuda", index))
    return buf


def counters(device) -> dict:
    """{name: count} of the tracer launches on a CUDA ``device`` since its
    first or the last ``reset_counters`` (``COUNTERS``; zeros where none
    ran), with one device-to-host copy. ``tests_needed / tests_issued`` is
    the share of the lane slots that tested a record a live ray needed."""
    return dict(zip(COUNTERS, counter_buffer(device).tolist()))


def reset_counters(device) -> None:
    counter_buffer(device).zero_()


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


def _dot3(v, w):
    """[R, 3] x [P, 3] -> [R, P], summed x + y + z left to right."""
    return (v[:, 0:1] * w[:, 0] + v[:, 1:2] * w[:, 1]) + v[:, 2:3] * w[:, 2]


def _hit_ts(mode, rows, o, d, t_min, sdo, soo):
    """[R, P] hit distances of the records ``rows`` of one test mode, BIG
    where a ray misses. ``sdo`` = D.O and ``soo`` = |O|^2 per ray."""
    if mode in SPHERE_MODES:
        c = rows[:, 0:3]
        bq = sdo[:, None] + -_dot3(d, c)
        q = soo[:, None] + (rows[:, 3] - 2.0 * _dot3(o, c))
        disc = bq * bq - q
        root = sqrt(torch.clamp_min(disc, 0.0))
        t = -bq - root
        if mode == 5:
            t = torch.where(t > t_min, t, -bq + root)
        ok = (disc > 0.0) & (t > t_min)
        return torch.where(ok, t, torch.full_like(t, BIG))
    pn, pd = rows[:, 0:3], rows[:, 3]
    numer = pd - _dot3(o, pn)
    denom = _dot3(d, pn)
    t = numer * (1.0 / denom)
    ok = t > t_min
    if mode != 2:
        w1, b1 = rows[:, 4:7], rows[:, 7]
        s1 = (_dot3(o, w1) - b1) + t * _dot3(d, w1)
    if mode in (0, 4, 6, 7):
        w2, b2 = rows[:, 8:11], rows[:, 11]
        s2 = (_dot3(o, w2) - b2) + t * _dot3(d, w2)
    if mode in (4, 7):
        ok = ok & (s1 >= 0) & (s2 >= 0) & (1.0 - (s1 + s2) >= 0)
    elif mode != 2:
        ok = ok & (s1 >= 0) & (1.0 - s1 >= 0)
        if mode != 1:
            ok = ok & (s2 >= 0) & (1.0 - s2 >= 0)
    return torch.where(ok, t, torch.full_like(t, BIG))


def _props(mode, rows, tex=None):
    """[P, SEL_WIDTH] properties of the records of one test mode; with the
    records' texture rows ``tex`` [P, 8], [P, TEX_SEL_WIDTH]."""
    pad = rows.new_zeros((rows.shape[0], 1))
    if mode in SPHERE_MODES:
        cols = [rows[:, 0:3], rows[:, 4:11], rows[:, 12:13], pad + 1.0, rows[:, 11:12]]
        if tex is not None:
            cols += [tex[:, 0:5], pad.expand(-1, 8)]
    else:
        cols = [rows[:, 0:3], rows[:, 12:19], pad, pad, rows[:, 19:20]]
        if tex is not None:
            cols += [tex[:, 0:5], rows[:, 4:12]]
    return torch.cat(cols, dim=1)


def _dense_nearest(groups, o, d, t_min, sdo, soo):
    """(t [R], sel [R, width]) over the records of ``groups``, a list of
    (mode, rows, props) tested jointly: one nearest t, the properties of the
    primitives tied exactly on it summed, zeros on a miss."""
    tv = torch.cat([_hit_ts(g[0], g[1], o, d, t_min, sdo, soo) for g in groups], dim=1)
    tmin = tv.min(dim=1).values
    thresh = torch.where(tmin < BIG, tmin, torch.full_like(tmin, -1.0))
    onehot = (tv <= thresh[:, None]).to(torch.float32)
    return tmin, onehot @ torch.cat([g[2] for g in groups])


def _slab_pass(box, o, inv_d, tmin, alive):
    """The reference's per-ray tile test: the ray enters the tile's box
    (entry and exit widened by a relative 1e-3) in front of it (a ray that
    starts inside has a negative entry and passes) and nearer than its
    running hit."""
    t1 = (box[0:3] - o) * inv_d
    t2 = (box[3:6] - o) * inv_d
    tn = torch.minimum(t1, t2).max(dim=1).values
    tf = torch.maximum(t1, t2).min(dim=1).values
    tn = tn - tn.abs() * _SLAB_WIDEN
    tf = tf + tf.abs() * _SLAB_WIDEN
    return (tf >= tn) & (tf > 0.0) & (tn < tmin) & alive


def _test_counts(mode: int, n: int) -> list:
    """[plane tests, edge tests, sphere tests] of one hit test of each of
    ``n`` records of a mode."""
    if mode in SPHERE_MODES:
        return [0, 0, n]
    return [n, n * EDGE_TESTS[mode], 0]


def _plain_tables(scene: DeviceScene, anchor: torch.Tensor):
    """What a pass of the plain version reads of the scene: ([(mode,
    records, properties, axis records) of each single-tile group], [(mode,
    records, properties, axis records, tile row) of each walked tile, in walk
    order]). A tile of padding only holds no record; it stays in the walk
    (its inverted box passes the slab test, which the diagnostics count) and
    is never tested."""
    rows = []
    n_axis = scene.axis_tiles[:, 2].tolist()
    for tile, axis in zip(scene.tiles.cpu().tolist(), n_axis):
        first, count, mode = int(tile[6]), int(tile[7]), int(tile[8])
        sph = mode in SPHERE_MODES
        records = (scene.spheres if sph else scene.planes)[first:first + count]
        tex = None
        if scene.textured:
            tex = (scene.sphere_tex if sph else scene.plane_tex)[first:first + count]
        rows.append((mode, records, _props(mode, records, tex), axis))
    n_single = sum(1 for g in scene.group_meta if g[2] == 1)
    order = tile_order(scene.tiles, scene.group_meta, anchor).tolist()
    return rows[:n_single], [rows[ti] + (scene.tiles[ti],) for ti in order]


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
    return_block_segments: bool = False,
):
    """The plain PyTorch version of the fused tracer: light [R, 3], and with
    ``return_block_segments`` (light, diagnostics [5, blocks] int32).

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
    before; ``plane_tests``, ``edge_tests`` and ``sphere_tests``, the hit
    tests and edge tests of those tiles' primitives and of the single-tile
    groups', and ``axis_tests``, the hit tests of the axis records among
    them; ``glass_hits``, the live hits on glass (each runs the
    dielectric stage); ``textured_hits``, the live hits on a textured
    primitive (each evaluates a checker). For warps of 32 consecutive rays
    (in the order given): ``warp_segments``, the (warp, segment) pairs with
    a live lane, and ``warp_tile_visits``, the (warp, segment, tile) triples
    where some lane's slab test passes, which a warp that keeps its rays
    scans. ``segments_per_ray`` is set to the segments each ray entered
    alive, [R] int32 (``utils/profiling.py warp_lane_share`` reads it).

    The diagnostics' blocks are ``ray_ids // B``. Without ``ray_ids`` the
    wavefront is padded to whole blocks as the reference pads it; with them
    it is taken as it is (whole blocks of a larger wavefront, say) and the
    columns run up to the last block named."""
    dev = ori.device
    n_rays, block = ori.shape[0], rows_per_block * LANES
    if anchor is None:
        anchor = torch.zeros(3, dtype=torch.float32, device=dev)
    if return_block_segments and ray_ids is None:
        ori, dirs, seed_row = _pad_to_blocks(ori, dirs, seed_row, block)
    if ray_ids is None:
        ray_ids = torch.arange(ori.shape[0], dtype=torch.int64, device=dev)
    rng = pcg_init(seed, ray_ids, block, seed_row)
    single, walk = _plain_tables(scene, anchor)
    diag = None
    if return_block_segments:
        n_blocks = int(ray_ids.max()) // block + 1 if ray_ids.numel() else 0
        diag = dict(votes=torch.zeros((cfg.max_segments, len(walk), n_blocks),
                                      dtype=torch.int32, device=dev),
                    segments=torch.zeros(n_blocks, dtype=torch.int32, device=dev),
                    live=torch.zeros(n_blocks, dtype=torch.int32, device=dev))
    widest = max([sum(g[1].shape[0] for g in single)] + [t[1].shape[0] for t in walk])
    # Whole warps per pass, so that no warp of the statistics is split.
    step = max(WARP, min(PLAIN_CHUNK, PLAIN_BUDGET // max(1, widest)) // WARP * WARP)
    parts, lived = [], []
    for c0 in range(0, ori.shape[0], step):
        sl = slice(c0, c0 + step)
        if diag is not None:
            diag["block"] = ray_ids[sl] // block
        light, seg = _trace_plain_chunk(single, walk, scene.has_glass, scene.textured,
                                        ori[sl], dirs[sl], rng[sl], cfg, stats, skip, diag)
        parts.append(light)
        lived.append(seg)
    light = torch.cat(parts)[:n_rays] if parts else torch.zeros_like(ori)
    if stats is not None:
        stats["segments_per_ray"] = (torch.cat(lived)[:n_rays] if lived else
                                     torch.zeros(0, dtype=torch.int32, device=dev))
    if diag is None:
        return light
    tiles = (diag["votes"] > 0).sum(dim=1, dtype=torch.int32)
    return light, _diag_rows(diag["segments"], diag["live"], tiles, len(single))


def _pad_to_blocks(ori, dirs, seed_row, block):
    """The wavefront padded with zero rays to whole blocks of ``block``
    rays, as the reference pads it: a padded ray misses everything and dies
    on its first segment."""
    pad = -ori.shape[0] % block
    if pad:
        ori = torch.cat([ori, ori.new_zeros((pad, 3))])
        dirs = torch.cat([dirs, dirs.new_zeros((pad, 3))])
        if seed_row is not None:
            seed_row = torch.cat([seed_row, seed_row.new_zeros(pad)])
    return ori, dirs, seed_row


def _diag_rows(segments, live, tiles, n_single):
    """The reference kernel's output rows 3-7, [5, blocks] int32, from the
    segments each block ran [blocks], the live rays entering its segments
    summed [blocks], and the walked tiles that some live ray of the block
    reached on each segment, ``tiles`` [max_segments, blocks]. The
    single-tile groups count once on every segment the block ran."""
    return torch.stack([
        segments,
        n_single * segments + tiles.sum(dim=0, dtype=torch.int32),
        n_single * segments.clamp(max=1) + tiles[:1].sum(dim=0, dtype=torch.int32),
        n_single * segments.clamp(max=3) + tiles[:3].sum(dim=0, dtype=torch.int32),
        live,
    ]).to(torch.int32)


def _warp_any(mask: torch.Tensor) -> torch.Tensor:
    """[ceil(R / 32)] bool: whether any ray of each warp of 32 consecutive
    rays is set in ``mask`` [R]."""
    return torch.nn.functional.pad(mask, (0, -mask.shape[0] % WARP)).view(-1, WARP).any(dim=1)


def _nearest(single, walk, o, d, t_min, alive, counts, skip, width, vote=None):
    """Nearest hit over all groups in the reference's merge order:
    (t [R], sel [R, width]). ``counts`` (or None) is a tensor of six
    sums over the walked tiles: tile visits, plane tests, edge tests,
    sphere tests, warp tile visits and axis tests. ``vote`` (or None) is
    (votes [walked tiles, blocks], the rays' blocks [R]): each walked tile's
    count of rays that reach it is added to its row."""
    sdo = (o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1]) + o[:, 2] * d[:, 2]
    soo = (o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1]) + o[:, 2] * o[:, 2]
    if single:
        tmin, sel = _dense_nearest(single, o, d, t_min, sdo, soo)
    else:
        tmin = torch.full_like(o[:, 0], BIG)
        sel = o.new_zeros((o.shape[0], width))
    if walk:
        inv_d = torch.clamp(1.0 / d, -BIG, BIG)
    for k, (mode, rows, props, n_axis, tile) in enumerate(walk):
        reach = _slab_pass(tile, o, inv_d, tmin, alive)
        if vote is not None:
            vote[0][k].index_add_(0, vote[1], reach.to(torch.int32))
        if rows.shape[0] == 0:
            continue
        if counts is not None:
            counts[:4] += reach.sum() * torch.tensor([1] + _test_counts(mode, rows.shape[0]),
                                                     device=counts.device)
            counts[4] += _warp_any(reach).sum()
            counts[5] += reach.sum() * n_axis
        tile_t, tile_sel = _dense_nearest([(mode, rows, props)], o, d, t_min, sdo, soo)
        better = tile_t < tmin
        if skip:
            better = better & reach
        tmin = torch.where(better, tile_t, tmin)
        sel = torch.where(better[:, None], tile_sel, sel)
    return tmin, sel


def _trace_plain_chunk(single, walk, has_glass, textured, o, d, rng, cfg, stats, skip, diag):
    t_min = _f32(cfg.t_min)
    width = TEX_SEL_WIDTH if textured else SEL_WIDTH
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
        counts = torch.zeros(6, dtype=torch.int64, device=o.device)
        glass_hits = torch.zeros((), dtype=torch.int64, device=o.device)
        textured_hits = torch.zeros((), dtype=torch.int64, device=o.device)
        per_segment = [1] + [sum(c) for c in zip(*(
            [_test_counts(g[0], g[1].shape[0]) + [g[3]] for g in single] or [[0, 0, 0, 0]]))]
    lived = torch.zeros_like(mh)                    # segments each ray entered alive
    for seg in range(cfg.max_segments):
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        lived = lived + alive.to(torch.int32)
        if stats is not None:
            for name, n in zip(("ray_segments", "plane_tests", "edge_tests", "sphere_tests",
                                "axis_tests"), per_segment):
                stats[name] = stats.get(name, 0) + n_alive * n
            stats["warp_segments"] = stats.get("warp_segments", 0) + int(_warp_any(alive).sum())
        vote = None if diag is None else (diag["votes"][seg], diag["block"])
        t, sel = _nearest(single, walk, o, d, t_min, alive, counts, skip, width, vote)
        n, c, e, mir = sel[:, 0:3], sel[:, 3:6], sel[:, 6:9], sel[:, 9]
        # A sphere's normal, from the same o + d t as the position update.
        is_sph = sel[:, 11] > 0.0
        n = torch.where(is_sph[:, None], ((o + d * t[:, None]) - n) * sel[:, 10:11], n)
        hit = alive & (t < BIG)
        if textured:
            # The checker: odd cells take the winner's second colour.
            tk, tsc = sel[:, 13], sel[:, 14]
            h = o + d * t[:, None]
            hx, hy, hz = h[:, 0], h[:, 1], h[:, 2]
            s1 = ((hx * sel[:, 18] + hy * sel[:, 19]) + hz * sel[:, 20]) - sel[:, 21]
            s2 = ((hx * sel[:, 22] + hy * sel[:, 23]) + hz * sel[:, 24]) - sel[:, 25]
            f1 = torch.floor(s1 * tsc) + torch.floor(s2 * tsc)
            f2 = (torch.floor(hx / tsc) + torch.floor(hy / tsc)) + torch.floor(hz / tsc)
            f = torch.where(tk > 1.5, f2, f1)
            odd = (f - 2.0 * torch.floor(f * 0.5)) > 0.5
            c = torch.where(((tk > 0.0) & odd)[:, None], sel[:, 15:18], c)
            if stats is not None:
                textured_hits += (hit & (tk > 0.0)).sum()
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
        if has_glass:
            ior = sel[:, 12]
            glass = hit & (ior > 0.0)
            mirror = mirror & ~glass
            diffuse = hit & ~mirror & ~glass
            spec = mirror | glass
            if stats is not None:
                glass_hits += glass.sum()
        else:
            diffuse = hit & ~mirror
            spec = mirror
        mh_new = mh + spec.to(torch.int32)
        mirror_live = mirror & (mh_new < cfg.mirror_limit)

        rng, word = _pcg_scramble(rng)
        u1 = (word & 0xFFFF).to(torch.float32) * (1.0 / 65536.0)
        u2 = (word >> 16).to(torch.float32) * (1.0 / 65536.0)
        z = u1 * 2.0 - 1.0
        x = u2 * 2.0 - 1.0
        k = torch.round(x)
        sphi = _sinpi(x - k) * (1.0 - 2.0 * torch.abs(k))
        cphi = _sinpi(0.5 - torch.abs(x))
        r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        u = torch.stack([r * cphi, r * sphi, z], dim=1)

        dif = diffuse[:, None]
        lt = torch.where(dif, lt + e * tp, lt)
        tp = torch.where(dif, tp * c, tp)
        lt = torch.where(mirror_live[:, None], lt + c * tint, lt)
        v = torch.where(dif, u + n * side[:, None], d - 2.0 * dn[:, None] * n)
        if has_glass:
            # Snell refraction on the unit direction, Schlick's reflectance.
            dinv = 1.0 / sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
            dh = d * dinv[:, None]
            ne = n * side[:, None]
            cos_i = torch.clamp(
                -((dh[:, 0] * ne[:, 0] + dh[:, 1] * ne[:, 1]) + dh[:, 2] * ne[:, 2]), 0.0, 1.0)
            eta = torch.where(side > 0.0, 1.0 / torch.clamp_min(ior, _f32(1e-6)), ior)
            sin2t = eta * eta * (1.0 - cos_i * cos_i)
            tir = sin2t > 1.0
            if cfg.fresnel:
                r0 = (1.0 - eta) / (1.0 + eta)
                r0 = r0 * r0
                p = 1.0 - cos_i
                p2 = p * p
                reflect_p = torch.where(tir, 1.0, r0 + (1.0 - r0) * (p2 * p2 * p))
                rng, word = _pcg_scramble(rng)
                u3 = (word >> 8).to(torch.float32) * (1.0 / (1 << 24))
                do_refl = u3 < reflect_p
            else:
                do_refl = tir
            coef = eta * cos_i - sqrt(torch.clamp_min(1.0 - sin2t, 0.0))
            dnh = dn * dinv
            g = torch.where(do_refl[:, None], dh - 2.0 * dnh[:, None] * n,
                            eta[:, None] * dh + coef[:, None] * ne)
            v = torch.where(glass[:, None], g, v)
            glass_live = glass & (mh_new < cfg.mirror_limit)
            tp = torch.where(glass_live[:, None], tp * c, tp)
        v_inv = 1.0 / sqrt((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2])
        o = o + d * t[:, None]
        d = v * v_inv[:, None]
        mh = mh_new
        dc = dc + diffuse.to(torch.int32)
        alive = hit & ~(spec & (mh_new >= cfg.mirror_limit)) & (dc < cfg.bounce_limit)
    if stats is not None:
        names = ("tile_visits", "plane_tests", "edge_tests", "sphere_tests", "warp_tile_visits",
                 "axis_tests", "glass_hits", "textured_hits")
        for name, n in zip(names, counts.tolist() + [int(glass_hits), int(textured_hits)]):
            stats[name] = stats.get(name, 0) + n
    if diag is not None:
        diag["segments"].scatter_reduce_(0, diag["block"], lived, "amax")
        diag["live"].index_add_(0, diag["block"], lived)
    return lt, lived


def trace_paths_fused(
    scene: DeviceScene,
    ori: torch.Tensor,          # [R, 3] float32
    dirs: torch.Tensor,         # [R, 3] float32
    seed: torch.Tensor,         # int32, one element, on the rays' device
    cfg: TracerConfig,
    rows_per_block: int,
    anchor: torch.Tensor | None = None,     # [3] float32 tile-order anchor (None = origin)
    seed_row: torch.Tensor | None = None,   # [R] float32 in [0, 1), mixed into the seeds
    return_block_segments: bool = False,
    grid_blocks: int | None = None,
    geometry: dict | None = None,
):
    """Trace a ray wavefront; returns light [R, 3], and with
    ``return_block_segments`` (light, the per-block diagnostics [5, ceil(R /
    B)] int32: the reference kernel's output rows 3-7). The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. A textured scene and
    the diagnostics each run instantiations of their own (libraries
    ``tracer_tex``, ``tracer_diag``, ``tracer_tex_diag``, built at first
    use), so that a launch without them compiles none of their code.
    ``grid_blocks`` caps the kernel's persistent grid (None: as many blocks
    as fill the card); the light never depends on it. A CUDA launch fills
    ``geometry`` (when given) with the geometry the launcher chose: blocks,
    threads, shared bytes, registers, blocks per SM, whether the whole
    scene was resident in shared memory and whether the axis route ran
    (``GEOMETRY``)."""
    dev = ori.device
    planes, spheres, tiles = scene.planes, scene.spheres, scene.tiles
    if anchor is None:
        anchor = torch.zeros(3, dtype=torch.float32, device=dev)
    checked = [("planes", planes, torch.float32), ("spheres", spheres, torch.float32),
               ("tiles", tiles, torch.float32),
               ("axis_entries", scene.axis_entries, torch.float32),
               ("axis_tiles", scene.axis_tiles, torch.int32),
               ("axis_runs", scene.axis_runs, torch.int32),
               ("ori", ori, torch.float32), ("dirs", dirs, torch.float32),
               ("seed", seed, torch.int32), ("anchor", anchor, torch.float32)]
    if scene.textured:
        checked += [("plane_tex", scene.plane_tex, torch.float32),
                    ("sphere_tex", scene.sphere_tex, torch.float32)]
    if seed_row is not None:
        checked.append(("seed_row", seed_row, torch.float32))
    for name, x, dtype in checked:
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got {x.dtype} on {x.device}")
    if ori.ndim != 2 or ori.shape[1] != 3 or dirs.shape != ori.shape:
        raise ValueError(f"ori/dirs must both be [R, 3], got {tuple(ori.shape)}, {tuple(dirs.shape)}")
    if (planes.ndim != 2 or planes.shape[1] != 20 or spheres.ndim != 2
            or spheres.shape[1] != SPHERE_RECORD_WIDTH or tiles.ndim != 2
            or tiles.shape[1] != TILE_WIDTH):
        raise ValueError("the scene must hold [P, 20] plane records, [S, 16] sphere records "
                         "and a [T, 9] tile table")
    if scene.textured and (tuple(scene.plane_tex.shape) != (planes.shape[0], TEX_WIDTH) or
                           tuple(scene.sphere_tex.shape) != (spheres.shape[0], TEX_WIDTH)):
        raise ValueError("a textured scene must hold [P, 8] and [S, 8] texture rows")
    if sum(g[2] for g in scene.group_meta) != tiles.shape[0]:
        raise ValueError("group_meta must account for every tile")
    if (scene.axis_entries.ndim != 2 or scene.axis_entries.shape[1] != 4
            or tuple(scene.axis_tiles.shape) != (tiles.shape[0], AXIS_TILE_WIDTH)
            or scene.axis_runs.ndim != 2 or scene.axis_runs.shape[1] != AXIS_RUN_WIDTH):
        raise ValueError("the scene's pass-1 tables must be [E, 4] entries, a [T, 4] row a "
                         "tile and [R, 4] runs (scenebuf.axis_tables)")
    if seed.numel() != 1:
        raise ValueError("seed must hold one int32")
    if anchor.shape != (3,):
        raise ValueError(f"anchor must be [3], got {tuple(anchor.shape)}")
    if seed_row is not None and seed_row.shape != ori.shape[:1]:
        raise ValueError(f"seed_row must be [R], got {tuple(seed_row.shape)}")
    if dev.type == "cpu":
        return trace_paths_plain(scene, ori, dirs, seed, cfg, rows_per_block,
                                 anchor=anchor, seed_row=seed_row,
                                 return_block_segments=return_block_segments)
    if dev.type != "cuda":
        raise ValueError(f"trace_paths_fused runs on cuda or cpu tensors, got {dev}")
    order = tile_order(tiles, scene.group_meta, anchor)
    n_rays, block = ori.shape[0], rows_per_block * LANES
    name, plane_tex, sphere_tex, segments, mask = "tracer", None, None, None, None
    if scene.textured:
        name += "_tex"
        plane_tex, sphere_tex = scene.plane_tex.contiguous(), scene.sphere_tex.contiguous()
    if return_block_segments:
        name += "_diag"
        ori, dirs, seed_row = _pad_to_blocks(ori, dirs, seed_row, block)
        n_blocks = ori.shape[0] // block
        # Per block: [the most segments a ray lived, the segments lived summed],
        # and per block and segment a bit for each walked tile a live ray reached.
        segments = torch.zeros((2, n_blocks), dtype=torch.int32, device=dev)
        mask = torch.zeros((n_blocks, cfg.max_segments, max(1, -(-order.shape[0] // 32))),
                           dtype=torch.int32, device=dev)
    ori, dirs, planes, spheres, tiles, seed = (
        x.contiguous() for x in (ori, dirs, planes, spheres, tiles, seed))
    axis_entries, axis_tiles, axis_runs = (
        x.contiguous() for x in (scene.axis_entries, scene.axis_tiles, scene.axis_runs))
    if seed_row is not None:
        seed_row = seed_row.contiguous()
    light = torch.empty_like(ori)
    lf = cfg.lighting_factor
    # Which stages the scene needs: triangles or spheres, and glass.
    modes = {g[0] for g in scene.group_meta}
    prims = bool(modes & {3, 4, 5, 7})
    ptr = lambda x: None if x is None else x.data_ptr()
    out = (ctypes.c_int * len(GEOMETRY))()
    with torch.cuda.device(dev):            # the launch goes to this device's stream
        if _graph_work:
            work = _graph_work[-1]
            if work.device != ori.device:
                raise ValueError(f"work counters on {work.device}, rays on {ori.device}")
        else:
            key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
            if key not in _work:
                _work[key] = torch.zeros(2, dtype=torch.int32, device=dev)
            work = _work[key]
        counts = counter_buffer(dev)
        kernels.launch(
            name, ori.data_ptr(), dirs.data_ptr(), planes.data_ptr(), planes.shape[0],
            spheres.data_ptr(), spheres.shape[0], ptr(plane_tex), ptr(sphere_tex),
            tiles.data_ptr(), tiles.shape[0], tiles.shape[0] - order.shape[0], order.data_ptr(),
            axis_entries.data_ptr(), axis_entries.shape[0], axis_tiles.data_ptr(),
            axis_runs.data_ptr(), axis_runs.shape[0], seed.data_ptr(), ptr(seed_row),
            light.data_ptr(), work.data_ptr(),
            counts.data_ptr(), ptr(segments), ptr(mask),
            0 if mask is None else mask.shape[2], ori.shape[0], block,
            cfg.max_segments, cfg.bounce_limit, cfg.mirror_limit,
            int(prims), int(scene.has_glass), int(cfg.fresnel),
            _f32(cfg.mirror_tint), _f32(cfg.t_min),
            *(_f32(c) for c in cfg.sky_color), _f32(cfg.sky_strength), _f32(lf),
            _f32(np.log(lf)) if lf > 0.0 else 0.0, grid_blocks or 0, out,
        )
    if geometry is not None:
        geometry.update(zip(GEOMETRY, out))
        geometry["resident"] = bool(geometry["resident"])
        geometry["axis"] = bool(geometry["axis"])
    if not return_block_segments:
        return light
    bits = (mask[..., None] >> torch.arange(32, dtype=torch.int32, device=dev)) & 1
    tiles_reached = bits.sum(dim=(2, 3), dtype=torch.int32).T     # [max_segments, blocks]
    return light[:n_rays], _diag_rows(segments[0], segments[1], tiles_reached,
                                      tiles.shape[0] - order.shape[0])
