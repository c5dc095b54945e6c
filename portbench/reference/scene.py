"""The reference's scene: the maze of a configuration file worked out again
from its seed, and the tables the plain tracer and the collision test read.

A frozen copy of the arithmetic of the port's ``render/scenebuf.py``
(``build_plane_table``, ``ordered_plane_table``, ``plane_records``,
``tile_table``) and ``upload_scene``'s collision boxes, for scenes of quads
with no spheres, glass or textures, which is what a generated maze of the
benchmark's configurations holds. NumPy and torch only.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from .builder import build_scene
from .bvh import build_bvh

BIG = 1e30
PLANE_TILE = 128
PLANE_WIDTH = 40
KIND_COL = 26
VALID_COL = 19
TILE_WIDTH = 9
N_MODES = 8


def maze_section(cfg: dict) -> types.SimpleNamespace:
    """The ``maze`` group as attributes (lists as tuples), with its world
    half extent."""
    m = types.SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cfg["maze"].items()})
    m.world_half_extent = m.cell_size * m.height / 2.0
    return m


def morton2(x, y):
    def spread(v):
        v = v & 0xFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v
    return spread(x) | (spread(y) << 1)


def plane_table(scene) -> np.ndarray:
    """The valid planes as [P, 40] rows, ordered by kind, then by the Morton
    code of the quad's box centre (x, z)."""
    der = scene.derived()
    p = der.normal.shape[0]
    t = np.zeros((p, PLANE_WIDTH), np.float32)
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
    o = np.asarray(scene.origin, np.float32)
    u = np.asarray(scene.u, np.float32)
    v = np.asarray(scene.v, np.float32)
    corners = np.stack([o, o + u, o + v, o + u + v], axis=1)
    t[:, 20:23] = corners.min(axis=1)
    t[:, 23:26] = corners.max(axis=1)
    t[:, 26] = np.asarray(scene.kind, np.float32)
    t = t[t[:, VALID_COL] > 0.0]
    lo, hi = t[:, 20:23], t[:, 23:26]
    cx = (lo[:, 0] + hi[:, 0]) * 0.5
    cz = (lo[:, 2] + hi[:, 2]) * 0.5
    qx = np.clip((cx - cx.min()) * 8.0, 0, 65535).astype(np.uint64)
    qz = np.clip((cz - cz.min()) * 8.0, 0, 65535).astype(np.uint64)
    return t[np.lexsort((morton2(qx, qz), t[:, KIND_COL]))]


def tiles_of(table: np.ndarray):
    """(records [P, 20] grouped by mode, tiles [T, 9], group_meta) as the
    tracer reads them: per mode, tiles of min(round_up(P, 8), 128) records
    with their box widened by 1e-2; single-tile groups first, then the
    multi-tile groups, most tiles first."""
    modes = table[:, KIND_COL].astype(np.int32)
    rows = table[np.argsort(modes, kind="stable")]
    records = np.concatenate([rows[:, 0:19], rows[:, 27:28]], axis=1)
    eps = np.float32(1e-2)
    groups, first = [], 0
    for mode in range(N_MODES):
        lo_all, hi_all = table[modes == mode, 20:23], table[modes == mode, 23:26]
        p = len(lo_all)
        if p == 0:
            continue
        p8 = -(-p // 8) * 8
        pt = min(p8, PLANE_TILE)
        out = []
        for k in range(-(-p8 // pt)):
            a, b = min(k * pt, p), min((k + 1) * pt, p)
            lo = lo_all[a:b].min(axis=0, initial=np.float32(BIG)) - eps
            hi = hi_all[a:b].max(axis=0, initial=np.float32(-BIG)) + eps
            out.append(np.concatenate([lo, hi, [first + a, b - a, mode]]).astype(np.float32))
        groups.append((mode, out))
        first += p
    single = [g for g in groups if len(g[1]) == 1]
    multi = sorted((g for g in groups if len(g[1]) > 1), key=lambda g: -len(g[1]))
    tiles, meta = [], []
    for mode, out in single + multi:
        meta.append((mode, len(tiles), len(out)))
        tiles += out
    return (np.ascontiguousarray(records, np.float32),
            np.array(tiles, np.float32).reshape(-1, TILE_WIDTH), tuple(meta))


class RefScene(NamedTuple):
    planes: torch.Tensor      # [P, 20] records grouped by mode
    tiles: torch.Tensor       # [T, 9]
    group_meta: tuple
    leaf_min: np.ndarray      # [L, 3] float32 collision boxes
    leaf_max: np.ndarray


def build(cfg: dict, device) -> RefScene:
    """The maze of ``cfg`` (its own seed) and its tables on ``device``."""
    if cfg["maze"]["glass_prob"] != 0.0:
        raise ValueError("the reference traces opaque mazes only")
    scene = build_scene(maze_section(cfg))
    records, tiles, meta = tiles_of(plane_table(scene))
    leaf_min, leaf_max = build_bvh(scene.origin, scene.u, scene.v).leaf_boxes()
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return RefScene(planes=as_dev(records), tiles=as_dev(tiles), group_meta=meta,
                    leaf_min=np.asarray(leaf_min, np.float32),
                    leaf_max=np.asarray(leaf_max, np.float32))
