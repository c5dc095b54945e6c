"""Device-resident scene buffers (counterpart of the JAX package's
``render/scenebuf.py``: what the fused tracer, the jnp-style backends of
render/intersect.py and the collision query read, with the in-step sphere
refresh).

The reference uploads its scene once at init (`main.rs:723-730`). Here the
upload builds the Morton/kind-ordered plane table of the JAX package's
Pallas tracer (same rows, same order, bitwise), the compact per-plane
records the CUDA tracer reads (planes and spheres, grouped by test mode),
the tile table (the reference's partition of each test mode's primitives
into tiles with a conservative AABB), the noise texture and the collision
boxes (BVH leaves and spheres). ``DeviceScene.prims`` is the scene once
more in SCENE order, the columns and the flat BVH the reference's jnp
backends read (``ScenePrims``): its indices are scene-order ids, never the
kernel's grouped order. The TPU's matrix-unit operand packing
(``_pack_group``) has no counterpart: the CUDA tracer tests planes per
thread with plain f32 arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.morton import morton2
from ..scene.builder import Scene
from ..scene.bvh import build_bvh
from ..utils.noise import generate_noise

BIG = 1e30
PLANE_TILE = 128    # rows per tile of a test mode's group (the reference's)

# Column layout of the [P, 40] plane table (the JAX package's
# pallas_tracer.PLANE_COLS).
PLANE_WIDTH = 40
KIND_COL = 26
VALID_COL = 19

# The fused tracer's per-plane record, [P, 20] float32 (render/fused_tracer.py
# and csrc/tracer.cu read these offsets): normal 0:3, d 3, w1 4:7, b1 7,
# w2 8:11, b2 11, albedo 12:15, premultiplied emission 15:18, is_mirror 18,
# ior 19 (0 = opaque). The records stand grouped by test mode.
RECORD_WIDTH = 20

# The per-sphere record, [S, 16] float32: centre 0:3, |c|^2 - r^2 3, albedo
# 4:7, premultiplied emission 7:10, is_mirror 10, ior 11, 1/r 12, padding.
SPHERE_RECORD_WIDTH = 16

# Column layout of the [S, 18] sphere table (the JAX package's
# pallas_tracer.build_sphere_table).
SPHERE_WIDTH = 18

# The texture rows, [P, 8] and [S, 8] float32, in record order and only for a
# textured scene (empty otherwise): tex_kind 0 (0 none, 1 UV checker, 2 world
# checker), tex_scale 1, tex_color2 2:5, padding. Only a winner reads them.
TEX_WIDTH = 8

# A row of the tile table, [T, 9] float32: box lo 0:3, box hi 3:6, first
# record 6, records 7, test mode 8.
TILE_WIDTH = 9

# Test modes (the reference's groups): 0 opaque quads tested on both edges,
# 1 on the along-wall edge only, 2 on no edge; 3 opaque spheres; 4 opaque
# triangles; 5 glass spheres; 6 glass quads (both edges whatever the kind);
# 7 glass triangles. Tiles of modes 3 and 5 index the sphere records, the
# others the plane records.
SPHERE_MODES = (3, 5)
GLASS_MODES = (5, 6, 7)
N_MODES = 8

# The pass-1 tables of the tracer's axis route (``axis_tables``, csrc/tracer.cu
# axis_min). A quad record (modes 0, 1, 2, 6) is an axis record when its
# normal has two components equal to +-0 and the third +-1, and each edge
# vector its mode tests (w1 in modes 0, 1 and 6, w2 in modes 0 and 6) has
# exactly one nonzero component. Its class is A + 3 B + 9 C: the axes of the
# normal, w1 and w2 (0 for an edge the mode does not test). AXIS_GENERAL is
# the class of the other records of a tile that holds axis records: the
# kernel tests them in the general form. A pass-1 entry is AXIS_EDGES[mode]
# float4s wide (one for modes 1 and 2): (sign(n_A) d, w1_B, b1, the record's
# index as int32 bits), then (w2_C, b2, 0, 0) in modes 0 and 6. The index
# counts in the record's scan: the single-tile groups' joint one (the tile's
# first record at the records of the single tiles before it), or its walked
# tile's own. A run of the [R, 4] int32 table: its first float4 in the
# entries, its entries, its class, and its axes A | B << 8 | C << 16 (0 for
# AXIS_GENERAL). A tile's row of the [T, 4] int32 table: its first run, its
# runs (0: the tile has no axis record), its axis records, and the sum over
# its axis runs of ceil(entries / 32) (the records a lane takes of them when
# the warp tests the tile for one ray).
AXIS_GENERAL = 27
AXIS_EDGES = {0: 2, 1: 1, 2: 0, 6: 2}
# The fewest axis records a scan (the single-tile groups together, or one
# walked tile) takes the axis route with. A scan pays a fixed cost on it
# (three reciprocals, the guard, the winner taken, the counts) and each class
# run about a record's test, while an axis record saves more than half of
# its test: the Cornell boxes' 7-wall rooms ran 50% slower with the route
# (H100), a maze's scans of 52 records and more run 27-41% faster.
AXIS_MIN_RECORDS = 16
AXIS_TILE_WIDTH = 4
AXIS_RUN_WIDTH = 4


class ScenePrims(NamedTuple):
    """The scene in scene order (the JAX package's DeviceScene columns),
    read by render/intersect.py and render/tracer.py. Plane ``i`` is row i
    of every plane field (invalid planes included, never hit); sphere ``i``
    is reported by the intersectors as ``num_planes + i``. ``ior`` and
    ``sph_ior`` are None in a scene without glass, ``tex`` and ``sph_tex``
    ([*, 5] rows: kind, scale, color2) None in an untextured one, as in the
    reference."""

    normal: torch.Tensor        # [N, 3]
    d: torch.Tensor             # [N]
    w1: torch.Tensor            # [N, 3]
    b1: torch.Tensor            # [N]
    w2: torch.Tensor            # [N, 3]
    b2: torch.Tensor            # [N]
    color: torch.Tensor         # [N, 3]
    is_mirror: torch.Tensor     # [N] bool
    emission: torch.Tensor      # [N, 4]
    valid: torch.Tensor         # [N] bool
    is_tri: torch.Tensor        # [N] bool (kind 3)
    sph_center: torch.Tensor    # [S, 3]
    sph_radius: torch.Tensor    # [S]
    sph_inv_r: torch.Tensor     # [S] 1 / radius
    sph_c2r2: torch.Tensor      # [S] |c|^2 - r^2, summed in float64, rounded once
    sph_color: torch.Tensor     # [S, 3]
    sph_is_mirror: torch.Tensor  # [S] bool
    sph_emission: torch.Tensor  # [S, 4]
    ior: torch.Tensor | None    # [N] or None
    sph_ior: torch.Tensor | None  # [S] or None
    tex: torch.Tensor | None    # [N, 5] or None
    sph_tex: torch.Tensor | None  # [S, 5] or None
    bvh_min: torch.Tensor       # [M, 3] flat BVH (`main.rs:74-81` layout)
    bvh_max: torch.Tensor       # [M, 3]
    bvh_left_first: torch.Tensor  # [M] int64
    bvh_count: torch.Tensor     # [M] int64
    bvh_prim: torch.Tensor      # [N] int64

    @property
    def num_planes(self) -> int:
        return self.normal.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    def to(self, device) -> "ScenePrims":
        return ScenePrims(*(None if x is None else x.to(device) for x in self))


class DeviceScene(NamedTuple):
    plane_table: torch.Tensor   # [P, 40] ordered plane table (reference layout)
    planes: torch.Tensor        # [P, 20] fused-tracer records, grouped by mode
    sphere_table: torch.Tensor  # [S, 18] sphere table (reference layout)
    spheres: torch.Tensor       # [S, 16] sphere records, opaque first, then glass
    mode_counts: tuple          # primitives of each test mode 0..7
    tiles: torch.Tensor         # [T, 9] tile table in merge order (tile_table)
    group_meta: tuple           # ((mode, first tile, tiles), ...) in merge order
    axis_entries: torch.Tensor  # [E, 4] float32 pass-1 entries (axis_tables)
    axis_tiles: torch.Tensor    # [T, 4] int32 each tile's runs of them
    axis_runs: torch.Tensor     # [R, 4] int32 the runs, one class each
    noise: torch.Tensor         # [S, S] noise texture in [0, 1) (noise_rng)
    leaf_min: torch.Tensor      # [L, 3] BVH leaf boxes and sphere boxes (collision)
    leaf_max: torch.Tensor      # [L, 3]
    plane_tex: torch.Tensor     # [P, 8] texture rows (TEX_WIDTH), [0, 8] untextured
    sphere_tex: torch.Tensor    # [S, 8] the same of the spheres
    sph_center: torch.Tensor    # [S, 3] sphere centres in scene order (make_sphere_refresh)
    sph_radius: torch.Tensor    # [S] their radii
    prims: ScenePrims           # the scene in scene order (render/intersect.py)

    @property
    def num_planes(self) -> int:
        return self.planes.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.spheres.shape[0]

    @property
    def textured(self) -> bool:
        """Some primitive is textured: the tracer's texture stage runs. A
        property of the whole scene, as in the reference, fixed at upload."""
        return self.plane_tex.shape[0] + self.sphere_tex.shape[0] > 0

    @property
    def has_glass(self) -> bool:
        """The scene has a glass group: the tracer's dielectric stage runs."""
        return any(g[0] in GLASS_MODES for g in self.group_meta)


def build_plane_table(der, scene=None) -> np.ndarray:
    """Pack SceneDerived into the [P, 40] table (the JAX package's
    pallas_tracer.build_plane_table, column for column). With the raw
    Scene, columns 20:26 carry each quad's AABB over its four corners (three
    for triangles); without it they default to (-BIG, +BIG)."""
    p = der.normal.shape[0]
    t = np.zeros((p, PLANE_WIDTH), np.float32)
    t[:, 20:23] = -BIG
    t[:, 23:26] = BIG
    t[:, 0:3] = der.normal
    t[:, 3] = der.d
    t[:, 4:7] = der.w1
    t[:, 7] = der.b1
    t[:, 8:11] = der.w2
    t[:, 11] = der.b2
    t[:, 12:15] = der.color
    t[:, 15:18] = der.emission[:, :3] * der.emission[:, 3:4]
    t[:, 18] = der.is_mirror.astype(np.float32)
    t[:, 19] = der.valid.astype(np.float32)
    if scene is not None:
        o = np.asarray(scene.origin, np.float32)
        u = np.asarray(scene.u, np.float32)
        v = np.asarray(scene.v, np.float32)
        corners = np.stack([o, o + u, o + v, o + u + v], axis=1)  # [P,4,3]
        t[:, 20:23] = corners.min(axis=1)
        t[:, 23:26] = corners.max(axis=1)
        tri = np.asarray(scene.kind) == 3
        if tri.any():
            c3 = corners[:, :3]
            t[tri, 20:23] = c3.min(axis=1)[tri]
            t[tri, 23:26] = c3.max(axis=1)[tri]
        t[:, 26] = np.asarray(scene.kind, np.float32)
        t[:, 27] = np.asarray(scene.ior, np.float32)
        t[:, 28] = np.asarray(scene.tex_kind, np.float32)
        t[:, 29] = np.asarray(scene.tex_scale, np.float32)
        t[:, 30:33] = np.asarray(scene.tex_color2, np.float32)
    return t


def spatial_plane_order_key(plane_table) -> np.ndarray:
    """Morton code [P] of each quad's AABB midpoint (x, z)."""
    t = np.asarray(plane_table)
    lo, hi = t[:, 20:23], t[:, 23:26]
    cx = (lo[:, 0] + hi[:, 0]) * 0.5
    cz = (lo[:, 2] + hi[:, 2]) * 0.5
    qx = np.clip((cx - cx.min()) * 8.0, 0, 65535).astype(np.uint64)
    qz = np.clip((cz - cz.min()) * 8.0, 0, 65535).astype(np.uint64)
    return morton2(qx, qz)


def ordered_plane_table(scene: Scene) -> np.ndarray:
    """Valid planes only, ordered by test kind, then Morton code within a
    kind (the JAX package's scenebuf._ordered_plane_table)."""
    table = build_plane_table(scene.derived(), scene)
    table = table[table[:, VALID_COL] > 0.0]
    order = np.lexsort((spatial_plane_order_key(table), table[:, KIND_COL]))
    return table[order]


def build_sphere_table(scene: Scene) -> np.ndarray:
    """The scene's spheres as the [S, 18] table of the JAX package's
    pallas_tracer.build_sphere_table, column for column: centre 0:3, 1/r 3,
    |c|^2 - r^2 4 (summed in float64, rounded once), albedo 5:8,
    premultiplied emission 8:11, is_mirror 11, ior 12, texture 13:18."""
    c = np.asarray(scene.sph_center, np.float32)
    r = np.asarray(scene.sph_radius, np.float32)
    em = np.asarray(scene.sph_emission, np.float32)
    t = np.zeros((c.shape[0], SPHERE_WIDTH), np.float32)
    t[:, 0:3] = c
    t[:, 3] = 1.0 / r
    t[:, 4] = (np.sum(c.astype(np.float64) ** 2, axis=-1)
               - r.astype(np.float64) ** 2).astype(np.float32)
    t[:, 5:8] = np.asarray(scene.sph_color, np.float32)
    t[:, 8:11] = em[:, :3] * em[:, 3:4]
    t[:, 11] = np.asarray(scene.sph_is_mirror).astype(np.float32)
    t[:, 12] = np.asarray(scene.sph_ior, np.float32)
    t[:, 13] = np.asarray(scene.sph_tex_kind, np.float32)
    t[:, 14] = np.asarray(scene.sph_tex_scale, np.float32)
    t[:, 15:18] = np.asarray(scene.sph_tex_color2, np.float32)
    return t


def plane_modes(table: np.ndarray) -> np.ndarray:
    """The test mode of each row of a plane table: the kind for an opaque
    quad, 4 for an opaque triangle (kind 3), 6 for a glass quad of any kind
    and 7 for a glass triangle."""
    kinds = table[:, KIND_COL].astype(np.int32)
    tri = kinds == 3
    glass = table[:, 27] > 0.0
    return np.where(glass, np.where(tri, 7, 6), np.where(tri, 4, kinds))


def plane_records(table: np.ndarray) -> tuple[np.ndarray, tuple]:
    """The fused tracer's [P, 20] records, grouped by test mode (within a
    mode in table order, as the reference's groups are), and the plane
    counts of the modes 0..7."""
    modes = plane_modes(table)
    rows = table[np.argsort(modes, kind="stable")]
    rec = np.concatenate([rows[:, 0:19], rows[:, 27:28]], axis=1)
    counts = tuple(int((modes == m).sum()) for m in range(N_MODES))
    return np.ascontiguousarray(rec, np.float32), counts


def sphere_record_order(sphere_table: np.ndarray) -> np.ndarray:
    """Which sphere of the table stands at each place of the records: the
    opaque spheres (mode 3) first, then the glass ones (mode 5), each in
    table order."""
    return np.argsort(sphere_table[:, 12] > 0.0, kind="stable")


def texture_rows(table: np.ndarray, sphere_table: np.ndarray):
    """(plane_tex [P, 8], sphere_tex [S, 8]): the texture parameters in
    record order, for a scene in which any primitive is textured; two empty
    [0, 8] arrays otherwise (the reference's per-scene ``textured`` flag: an
    untextured scene carries and traces nothing more than it did)."""
    empty = np.zeros((0, TEX_WIDTH), np.float32)
    if not ((table[:, 28] > 0).any() or (sphere_table[:, 13] > 0).any()):
        return empty, empty
    rows = table[np.argsort(plane_modes(table), kind="stable")]
    plane_tex = np.zeros((rows.shape[0], TEX_WIDTH), np.float32)
    plane_tex[:, 0:5] = rows[:, 28:33]
    t = sphere_table[sphere_record_order(sphere_table)]
    sphere_tex = np.zeros((t.shape[0], TEX_WIDTH), np.float32)
    sphere_tex[:, 0:5] = t[:, 13:18]
    return plane_tex, sphere_tex


def sphere_records(sphere_table: np.ndarray) -> np.ndarray:
    """The [S, 16] sphere records, the opaque spheres (mode 3) first, then
    the glass ones (mode 5), each in table order."""
    t = sphere_table[sphere_record_order(sphere_table)]
    rec = np.zeros((t.shape[0], SPHERE_RECORD_WIDTH), np.float32)
    rec[:, 0:3] = t[:, 0:3]
    rec[:, 3] = t[:, 4]
    rec[:, 4:12] = t[:, 5:13]
    rec[:, 12] = t[:, 3]
    return rec


def tile_table(table: np.ndarray, tile_by_mode: dict | None = None,
               sphere_table: np.ndarray | None = None):
    """The reference's tile partition of an ordered plane table (valid rows
    only, ordered by kind) and a sphere table: (tiles [T, 9] float32,
    group_meta).

    The primitives of one test mode, in table order, are cut into tiles of
    pt = min(round_up(P, 8), tile) of them, tile = ``tile_by_mode[mode]`` or
    PLANE_TILE. A tile's row is AABB lo 0:3 and hi 3:6, its first record 6
    and its record count 7 (indices into ``plane_records`` or, for the
    sphere modes, ``sphere_records``), and its mode 8. The box is the
    min/max of the planes' columns 20:26, or of the spheres' centre -+ 1/inv_r,
    inflated by 1e-2 so the tracer's skip stays conservative; an empty box
    for a tile of padding only.

    Tiles stand in the tracer's merge order, one ``(mode, first tile,
    tiles)`` entry of ``group_meta`` per group: the single-tile groups
    first, in mode order (tested jointly), then the multi-tile groups, most
    tiles first (ties keep the mode order)."""
    if np.any(np.diff(table[:, KIND_COL]) < 0):
        raise ValueError("the plane table must be ordered by kind")
    if sphere_table is None:
        sphere_table = np.zeros((0, SPHERE_WIDTH), np.float32)
    centre = sphere_table[:, 0:3]
    radius = np.float32(1.0) / sphere_table[:, 3:4]
    # (mode of each primitive, its box lo, its box hi), planes and spheres.
    planes = (plane_modes(table), table[:, 20:23], table[:, 23:26])
    spheres = (np.where(sphere_table[:, 12] > 0.0, 5, 3), centre - radius, centre + radius)
    eps = np.float32(1e-2)
    groups = []
    first = {False: 0, True: 0}     # next record: of the planes, of the spheres
    for mode in range(N_MODES):
        is_sph = mode in SPHERE_MODES
        of_mode, lo_all, hi_all = spheres if is_sph else planes
        lo_all, hi_all = lo_all[of_mode == mode], hi_all[of_mode == mode]
        p = len(lo_all)
        if p == 0:
            continue
        p8 = -(-p // 8) * 8
        pt = min(p8, (tile_by_mode or {}).get(mode, PLANE_TILE))
        rows = []
        for k in range(-(-p8 // pt)):
            a, b = min(k * pt, p), min((k + 1) * pt, p)
            lo = lo_all[a:b].min(axis=0, initial=np.float32(BIG)) - eps
            hi = hi_all[a:b].max(axis=0, initial=np.float32(-BIG)) + eps
            rows.append(np.concatenate([lo, hi, [first[is_sph] + a, b - a, mode]])
                        .astype(np.float32))
        groups.append((mode, rows))
        first[is_sph] += p
    single = [g for g in groups if len(g[1]) == 1]
    multi = sorted((g for g in groups if len(g[1]) > 1), key=lambda g: -len(g[1]))
    tiles, meta = [], []
    for mode, rows in single + multi:
        meta.append((mode, len(tiles), len(rows)))
        tiles += rows
    return np.array(tiles, np.float32).reshape(-1, TILE_WIDTH), tuple(meta)


def axis_classes(rows: np.ndarray, mode: int) -> np.ndarray:
    """[n] int32: the class of each plane record ``rows`` [n, 20] of a quad
    test mode, AXIS_GENERAL where it is not an axis record. From the
    records' own values alone."""
    n = rows[:, 0:3]
    ok = ((n != 0).sum(axis=1) == 1) & (np.abs(n).max(axis=1) == 1)
    code = np.argmax(n != 0, axis=1)
    for k, cols in enumerate((slice(4, 7), slice(8, 11))[:AXIS_EDGES[mode]]):
        w = rows[:, cols] != 0
        ok &= w.sum(axis=1) == 1
        code += 3 ** (k + 1) * np.argmax(w, axis=1)
    return np.where(ok, code, AXIS_GENERAL).astype(np.int32)


def axis_tables(records: np.ndarray, tiles: np.ndarray, group_meta: tuple):
    """The pass-1 tables of the plane records [P, 20] cut into ``tiles``
    [T, 9] of ``group_meta`` (tile_table): (entries [E, 4] float32, tile
    rows [T, 4] int32, runs [R, 4] int32), laid out as AXIS_GENERAL says.

    A scan with at least AXIS_MIN_RECORDS axis records takes the axis route:
    the single-tile groups together, or a walked tile alone, in a scene of
    quads alone (no triangle or sphere tile). Each of its
    quad tiles that holds an axis record gives an entry for each of its
    records: its axis records sorted stably by class, then its others in
    record order, one run a class. Other tiles give none; a scene none of
    whose scans takes the route gives empty tables, and its launches run
    the general scan alone.

    The kernel's axis test is exact: for finite o and d and t_min > 0, t =
    (sign(n_A) d - o_A) (1 / d_A) and s = (w_B o_B - b) + t (w_B d_B) round
    to the general test's values up to the sign of a zero, which no accept
    reads (csrc/tracer.cu says why)."""
    entries, runs = [], []
    rows = np.zeros((tiles.shape[0], AXIS_TILE_WIDTH), np.int32)
    n_single = sum(1 for g in group_meta if g[2] == 1)
    base = np.cumsum([0] + [int(t[7]) for t in tiles[:n_single]])
    classes = []
    for tile in tiles:
        first, count, mode = int(tile[6]), int(tile[7]), int(tile[8])
        classes.append(axis_classes(records[first:first + count], mode) if mode in AXIS_EDGES
                       else np.full(count, AXIS_GENERAL, np.int32))
    n_axis = [int((c != AXIS_GENERAL).sum()) for c in classes]
    # Beside triangles or spheres no scan takes the route: the kernels with
    # those stages are built without it (csrc/tracer.cu launch_stages).
    quads = all(int(t[8]) in AXIS_EDGES for t in tiles)
    engaged = [quads and n >= AXIS_MIN_RECORDS for n in n_axis]
    engaged[:n_single] = [quads and sum(n_axis[:n_single]) >= AXIS_MIN_RECORDS] * n_single
    at = 0                                  # float4s so far
    for ti, tile in enumerate(tiles):
        first, count, mode = int(tile[6]), int(tile[7]), int(tile[8])
        if not (engaged[ti] and n_axis[ti]):
            continue
        rec = records[first:first + count]
        cls = classes[ti]
        order = np.argsort(cls, kind="stable")
        width = max(1, AXIS_EDGES[mode])
        ent = np.zeros((count, 4 * width), np.float32)
        for e, k in enumerate(order):
            ent[e, 3] = np.int32(k + (base[ti] if ti < n_single else 0)).view(np.float32)
            c = int(cls[k])
            if c == AXIS_GENERAL:
                continue
            a, b, cc = c % 3, c // 3 % 3, c // 9
            ent[e, 0] = rec[k, a] * rec[k, 3]           # sign(n_A) d, exact
            ent[e, 1:3] = rec[k, 4 + b], rec[k, 7]
            if width == 2:
                ent[e, 4:6] = rec[k, 8 + cc], rec[k, 11]
        starts = np.flatnonzero(np.diff(cls[order], prepend=-1))
        lengths = np.diff(np.append(starts, count))
        codes = cls[order][starts]
        slots = sum(-(-int(n) // 32) for n, c in zip(lengths, codes) if c != AXIS_GENERAL)
        rows[ti] = (len(runs), len(starts), n_axis[ti], slots)
        runs += [(at + int(s) * width, int(n), int(c),
                  0 if c == AXIS_GENERAL else c % 3 | (c // 3 % 3) << 8 | (c // 9) << 16)
                 for s, n, c in zip(starts, lengths, codes)]
        entries.append(ent.reshape(-1, 4))
        at += count * width
    return (np.concatenate(entries) if entries else np.zeros((0, 4), np.float32),
            rows, np.array(runs, np.int32).reshape(-1, AXIS_RUN_WIDTH))


def upload_scene(scene: Scene, device=None, noise: np.ndarray | None = None,
                 tile_by_mode: dict | None = None) -> DeviceScene:
    """Derive the tracer tables and the collision boxes and place them on
    ``device`` (None = the CUDA card). ``noise`` replaces the generated
    512x512 noise texture; ``tile_by_mode`` ({mode: primitives}) overrides
    the tile size per test mode, which lets a small scene have many tiles.
    Collision sees a sphere as its bounding box, appended to the BVH's leaf
    boxes."""
    dev = resolve_device(device)
    table = ordered_plane_table(scene)
    sphere_table = build_sphere_table(scene)
    records, counts = plane_records(table)
    n_glass = int((sphere_table[:, 12] > 0.0).sum())
    counts = counts[:3] + (len(sphere_table) - n_glass, counts[4], n_glass) + counts[6:]
    tiles, group_meta = tile_table(table, tile_by_mode, sphere_table)
    axis_entries, axis_tiles, axis_runs = axis_tables(records, tiles, group_meta)
    if noise is None:
        noise = generate_noise()
    bvh = build_bvh(scene.origin, scene.u, scene.v)
    leaf_min, leaf_max = bvh.leaf_boxes()
    if scene.num_spheres:
        centre = np.asarray(scene.sph_center, np.float32)
        radius = np.asarray(scene.sph_radius, np.float32)[:, None]
        leaf_min = np.concatenate([leaf_min, centre - radius], axis=0)
        leaf_max = np.concatenate([leaf_max, centre + radius], axis=0)
    plane_tex, sphere_tex = texture_rows(table, sphere_table)
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return DeviceScene(
        plane_table=as_dev(table),
        planes=as_dev(records),
        sphere_table=as_dev(sphere_table),
        spheres=as_dev(sphere_records(sphere_table)),
        mode_counts=counts,
        tiles=as_dev(tiles),
        group_meta=group_meta,
        axis_entries=as_dev(axis_entries),
        axis_tiles=torch.from_numpy(axis_tiles).to(dev),
        axis_runs=torch.from_numpy(axis_runs).to(dev),
        noise=as_dev(noise),
        leaf_min=as_dev(leaf_min),
        leaf_max=as_dev(leaf_max),
        plane_tex=as_dev(plane_tex),
        sphere_tex=as_dev(sphere_tex),
        sph_center=as_dev(np.asarray(scene.sph_center, np.float32).reshape(-1, 3)),
        sph_radius=as_dev(np.asarray(scene.sph_radius, np.float32).reshape(-1)),
        prims=scene_prims(scene, bvh, dev),
    )


def _pack_tex(kind, scale, color2) -> np.ndarray:
    """[*, 5] texture rows: (kind, scale, color2 rgb)."""
    return np.concatenate([np.asarray(kind, np.float32).reshape(-1, 1),
                           np.asarray(scale, np.float32).reshape(-1, 1),
                           np.asarray(color2, np.float32).reshape(-1, 3)], axis=1)


def scene_prims(scene: Scene, bvh, device) -> ScenePrims:
    """The scene-order view (the JAX package's upload_scene columns, value
    for value) on ``device``. The scene is textured iff a valid primitive
    is, the predicate of the tile tables; it has glass iff some ior > 0."""
    der = scene.derived()
    dev = torch.device(device)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    i64 = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    flag = lambda a: torch.from_numpy(np.asarray(a, bool).copy()).to(dev)
    centre = np.asarray(scene.sph_center, np.float32).reshape(-1, 3)
    radius = np.asarray(scene.sph_radius, np.float32).reshape(-1)
    c2r2 = (np.sum(centre.astype(np.float64) ** 2, axis=-1)
            - radius.astype(np.float64) ** 2).astype(np.float32)
    textured = bool(np.any((np.asarray(scene.tex_kind) > 0) & np.asarray(der.valid))
                    or (scene.num_spheres and np.any(np.asarray(scene.sph_tex_kind) > 0)))
    ior = np.asarray(scene.ior, np.float32)
    sph_ior = np.asarray(scene.sph_ior, np.float32).reshape(-1)
    return ScenePrims(
        normal=f32(der.normal), d=f32(der.d), w1=f32(der.w1), b1=f32(der.b1),
        w2=f32(der.w2), b2=f32(der.b2), color=f32(der.color),
        is_mirror=flag(der.is_mirror), emission=f32(der.emission), valid=flag(der.valid),
        is_tri=flag(np.asarray(scene.kind) == 3),
        sph_center=f32(centre), sph_radius=f32(radius),
        sph_inv_r=f32((1.0 / radius).astype(np.float32)), sph_c2r2=f32(c2r2),
        sph_color=f32(np.asarray(scene.sph_color, np.float32).reshape(-1, 3)),
        sph_is_mirror=flag(np.asarray(scene.sph_is_mirror, bool).reshape(-1)),
        sph_emission=f32(np.asarray(scene.sph_emission, np.float32).reshape(-1, 4)),
        ior=f32(ior) if np.any(ior > 0) else None,
        sph_ior=f32(sph_ior) if scene.num_spheres and np.any(sph_ior > 0) else None,
        tex=f32(_pack_tex(scene.tex_kind, scene.tex_scale, scene.tex_color2))
        if textured else None,
        sph_tex=f32(_pack_tex(scene.sph_tex_kind, scene.sph_tex_scale, scene.sph_tex_color2))
        if textured else None,
        bvh_min=f32(bvh.aabb_min), bvh_max=f32(bvh.aabb_max),
        bvh_left_first=i64(bvh.left_first), bvh_count=i64(bvh.count),
        bvh_prim=i64(bvh.prim_index),
    )


def make_sphere_refresh(scene: DeviceScene):
    """``refresh(scene) -> scene`` that derives everything the tracer reads
    of the spheres again from the scene's ``sph_center`` and ``sph_radius``
    tensors, on their device and without a host fetch (the JAX package's
    scenebuf.make_sphere_refresh): put in front of a step, it lets spheres
    whose centres were moved on the device (``scene._replace(sph_center=
    ...)``) be traced where they are. Rebuilt: the sphere table's centre, 1/r
    and |c|^2 - r^2 (summed in float64 and rounded once, as at upload), the
    sphere records, the boxes of the sphere tiles, and the same four of the
    scene-order view (``prims``, which the jnp-style backends read). The
    opaque/glass partition, the tiles' extents and the textured flag are
    fixed at upload and captured here. The collision boxes stay as uploaded, as in the
    reference, whose moved spheres (avatars) do not collide. Returns None for
    a sphere-free scene."""
    if scene.num_spheres == 0:
        return None
    dev = scene.spheres.device
    order = torch.from_numpy(
        sphere_record_order(scene.sphere_table.cpu().numpy())).to(dev)
    tile_rows = [(i, int(t[6]), int(t[7])) for i, t in enumerate(scene.tiles.cpu().tolist())
                 if int(t[8]) in SPHERE_MODES and int(t[7]) > 0]
    eps = float(np.float32(1e-2))

    def refresh(d: DeviceScene) -> DeviceScene:
        c, r = d.sph_center, d.sph_radius
        c64, r64 = c.double(), r.double()
        c2r2 = (((c64[:, 0] * c64[:, 0] + c64[:, 1] * c64[:, 1]) + c64[:, 2] * c64[:, 2])
                - r64 * r64).float()
        inv_r = 1.0 / r
        table = d.sphere_table.clone()
        table[:, 0:3] = c
        table[:, 3] = inv_r
        table[:, 4] = c2r2
        rec = d.spheres.clone()
        rec[:, 0:3] = c[order]
        rec[:, 3] = c2r2[order]
        rec[:, 12] = inv_r[order]
        radius = (1.0 / rec[:, 12])[:, None]
        lo, hi = rec[:, 0:3] - radius, rec[:, 0:3] + radius
        tiles = d.tiles.clone()
        for ti, first, count in tile_rows:
            tiles[ti, 0:3] = lo[first:first + count].min(dim=0).values - eps
            tiles[ti, 3:6] = hi[first:first + count].max(dim=0).values + eps
        prims = d.prims._replace(sph_center=c, sph_radius=r, sph_inv_r=inv_r, sph_c2r2=c2r2)
        return d._replace(sphere_table=table, spheres=rec, tiles=tiles, prims=prims)

    return refresh
