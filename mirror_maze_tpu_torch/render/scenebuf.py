"""Device-resident scene buffers (counterpart of the JAX package's
``render/scenebuf.py``, reduced to what the fused tracer and the collision
query read).

The reference uploads its scene once at init (`main.rs:723-730`). Here the
upload builds the Morton/kind-ordered plane table of the JAX package's
Pallas tracer (same rows, same order, bitwise), the compact per-plane
record the CUDA tracer reads, the tile table (the reference's partition of
each test mode's rows into tiles with a conservative AABB), the noise
texture and the BVH leaf boxes. The TPU's matrix-unit operand packing
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
# test mode 19 (0 full quad, 1 along-wall edge only, 2 no edge test).
RECORD_WIDTH = 20


class DeviceScene(NamedTuple):
    plane_table: torch.Tensor   # [P, 40] ordered plane table (reference layout)
    planes: torch.Tensor        # [P, 20] fused-tracer records, same order
    mode_counts: tuple          # (planes of mode 0, of mode 1, of mode 2)
    tiles: torch.Tensor         # [T, 8] tile table in merge order (tile_table)
    group_meta: tuple           # ((mode, first tile, tiles), ...) in merge order
    noise: torch.Tensor         # [S, S] noise texture in [0, 1) (noise_rng)
    leaf_min: torch.Tensor      # [L, 3] BVH leaf boxes (collision)
    leaf_max: torch.Tensor      # [L, 3]

    @property
    def num_planes(self) -> int:
        return self.planes.shape[0]


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


def plane_records(table: np.ndarray) -> tuple[np.ndarray, tuple]:
    """The fused tracer's [P, 20] records and its per-mode plane counts.

    Raises for what this tracer does not trace yet: triangles (kind 3),
    glass (ior > 0) and textures."""
    kinds = table[:, KIND_COL]
    if (kinds > 2).any() or (table[:, 27] > 0).any() or (table[:, 28] > 0).any():
        raise NotImplementedError(
            "the fused tracer traces opaque, untextured quads of kinds 0-2 "
            "only (triangles, glass and textures are not ported yet)"
        )
    rec = np.concatenate([table[:, 0:19], table[:, KIND_COL:KIND_COL + 1]], axis=1)
    counts = tuple(int((kinds == m).sum()) for m in (0, 1))
    return np.ascontiguousarray(rec, np.float32), counts + (len(table) - sum(counts),)


def tile_table(table: np.ndarray, tile_by_mode: dict | None = None):
    """The reference's tile partition of an ordered plane table (valid rows
    only, grouped by test mode 0, 1, 2): (tiles [T, 8] float32, group_meta).

    Within a mode the rows are cut into tiles of pt = min(round_up(P, 8),
    tile) rows, tile = ``tile_by_mode[mode]`` or PLANE_TILE. A tile's row is
    AABB lo 0:3 and hi 3:6 (min/max of its rows' columns 20:26, inflated by
    1e-2 so the tracer's skip stays conservative; an empty box for a tile of
    padding only), its first table row 6 and its row count 7.

    Tiles stand in the tracer's merge order, one ``(mode, first tile,
    tiles)`` entry of ``group_meta`` per group: the single-tile groups
    first (tested jointly), then the multi-tile groups, most tiles first
    (ties keep the mode order)."""
    kinds = table[:, KIND_COL]
    if np.any(np.diff(kinds) < 0):
        raise ValueError("the plane table must be ordered by test mode")
    groups = []
    row0 = 0
    for mode in (0, 1, 2):
        p = int((kinds == mode).sum())
        if p == 0:
            continue
        p8 = -(-p // 8) * 8
        pt = min(p8, (tile_by_mode or {}).get(mode, PLANE_TILE))
        rows = []
        for k in range(-(-p8 // pt)):
            a, b = min(k * pt, p), min((k + 1) * pt, p)
            box = table[row0 + a:row0 + b, 20:26]
            lo = box[:, 0:3].min(axis=0, initial=np.float32(BIG)) - np.float32(1e-2)
            hi = box[:, 3:6].max(axis=0, initial=np.float32(-BIG)) + np.float32(1e-2)
            rows.append(np.concatenate([lo, hi, [row0 + a, b - a]]).astype(np.float32))
        groups.append((mode, rows))
        row0 += p
    single = [g for g in groups if len(g[1]) == 1]
    multi = sorted((g for g in groups if len(g[1]) > 1), key=lambda g: -len(g[1]))
    tiles, meta = [], []
    for mode, rows in single + multi:
        meta.append((mode, len(tiles), len(rows)))
        tiles += rows
    return np.array(tiles, np.float32).reshape(-1, 8), tuple(meta)


def upload_scene(scene: Scene, device=None, noise: np.ndarray | None = None,
                 tile_by_mode: dict | None = None) -> DeviceScene:
    """Derive the tracer tables and the collision boxes and place them on
    ``device`` (None = the CUDA card). ``noise`` replaces the generated
    512x512 noise texture; ``tile_by_mode`` ({mode: rows}) overrides the
    tile size per test mode, which lets a small scene have many tiles."""
    dev = resolve_device(device)
    if scene.num_spheres:
        raise NotImplementedError("spheres are not ported yet")
    table = ordered_plane_table(scene)
    records, counts = plane_records(table)
    tiles, group_meta = tile_table(table, tile_by_mode)
    if noise is None:
        noise = generate_noise()
    leaf_min, leaf_max = build_bvh(scene.origin, scene.u, scene.v).leaf_boxes()
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return DeviceScene(
        plane_table=as_dev(table),
        planes=as_dev(records),
        mode_counts=counts,
        tiles=as_dev(tiles),
        group_meta=group_meta,
        noise=as_dev(noise),
        leaf_min=as_dev(leaf_min),
        leaf_max=as_dev(leaf_max),
    )
