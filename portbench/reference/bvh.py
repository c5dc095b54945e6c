"""A frozen copy of the port's module for the benchmark's plain reference.

SAH BVH builder over plane quads (init-time, host side; a copy of the
JAX package's NumPy builder).

Reimplements the reference's recursive full-sweep SAH builder
(`main.rs:74-263`) with identical split semantics but an O(k log k) sweep
per node instead of the reference's O(k^2) candidate loop: primitives are
sorted per axis and prefix/suffix AABBs give every candidate's cost in one
vectorized pass.

Semantics preserved from the reference:
- node bounds grow over the quad corners. DELIBERATE FIX vs the
  reference: `main.rs:91-101` grows over only THREE corners (origin,
  origin+u, origin+v), which is tight for its axis-aligned maze quads
  but MISSES the far-corner triangle of a rotated quad — the traversal
  and host collision then skip real geometry (found by the rotated
  Cornell-box blocks, tests/test_examples.py). We grow over all four;
  for axis-aligned quads min/max over four corners equals the
  reference's three, so maze BVHs are bit-identical to before;
- every primitive centroid on every axis is a split candidate, cost =
  count * half-surface-area per side (`main.rs:118-129, 180-211`);
- candidates with an empty side evaluate to 1e30, matching the reference
  where the empty default box's f32 area overflows to inf and
  0 * inf = NaN fails its `cost > 0` check (`main.rs:205-210`);
- ties select the LAST candidate in (axis-major, primitive-order) iteration
  order, matching `cost <= best_cost` (`main.rs:123`);
- subdivision aborts when the best cost exceeds the parent's
  count * area cost (`main.rs:130-135`), or when the partition would be
  empty on either side (`main.rs:159-161`), or at a single primitive;
- flat layout: root at index 0, children adjacent, interior nodes have
  count == 0 and left_first = left-child index; leaves have count >= 1 and
  left_first = offset into the primitive index permutation (`main.rs:162-178`).

Deviation (documented): the in-place two-pointer partition of the reference
(`main.rs:141-157`) reverses right-side primitive order; we use a stable
partition. Leaf contents are identical sets, internal order may differ.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

BIG = 1e30


@dataclasses.dataclass
class BVH:
    """Flat BVH arrays (device-uploadable)."""

    aabb_min: np.ndarray     # [M, 3] float32
    aabb_max: np.ndarray     # [M, 3] float32
    left_first: np.ndarray   # [M] int32: child index (interior) / prim offset (leaf)
    count: np.ndarray        # [M] int32: 0 = interior, >=1 = leaf prim count
    prim_index: np.ndarray   # [N] int32 permutation of primitive ids

    @property
    def num_nodes(self) -> int:
        return self.left_first.shape[0]

    def leaf_boxes(self) -> tuple[np.ndarray, np.ndarray]:
        """AABBs of all leaf nodes — the collision query set (see
        scene/collision.py)."""
        leaf = self.count >= 1
        return self.aabb_min[leaf], self.aabb_max[leaf]

    def depth(self) -> int:
        """Maximum node depth (root = 1); bounds traversal stack size."""
        depths = np.zeros(self.num_nodes, dtype=np.int64)
        depths[0] = 1
        # children always appear after parents in the flat layout
        for i in range(self.num_nodes):
            if self.count[i] == 0:
                lf = self.left_first[i]
                depths[lf] = depths[lf + 1] = depths[i] + 1
        return int(depths.max(initial=1))


def traversal_bounds(left_first, count) -> tuple[int, int]:
    """(max_depth, max_leaf) that make the masked traversal
    (render/intersect.py nearest_hit_bvh) exact for this tree.

    The SAH builder legitimately emits leaves of ANY size (subdivision
    aborts when the best split costs more than the parent, and coincident
    centroids force one-sided partitions), so traversal bounds must come
    from the BUILT tree — a fixed max_leaf silently drops primitives and
    a fixed max_depth silently corrupts the stack. Host-side numpy walk,
    run once at step build."""
    lf = np.asarray(left_first)
    ct = np.asarray(count)
    m = lf.shape[0]
    depths = np.zeros(m, dtype=np.int64)
    depths[0] = 1
    for i in range(m):
        if ct[i] == 0:
            c = lf[i]
            depths[c] = depths[c + 1] = depths[i] + 1
    return int(depths.max(initial=1)), int(ct.max(initial=1))


def _half_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    e = bmax - bmin
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def build_bvh(origin: np.ndarray, u: np.ndarray, v: np.ndarray) -> BVH:
    """Build the BVH over quads given by (origin, u, v), all [N, 3].

    The NumPy sweep only: the JAX package's optional C++ builder produces
    identical output by construction, so the port does not carry it.
    """
    n = origin.shape[0]
    # All FOUR growth corners per quad (the reference uses three,
    # `main.rs:95-97` — see the module docstring for why that is a bug
    # for rotated quads) and centroids (`main.rs:69-71`:
    # origin + (u + v) / 2). Promote to float64 BEFORE the adds — the
    # C++ twin (bvh_builder.cpp) sums in double, and a float32 rounding
    # on e.g. -49.9 + 9.9 can flip the strict-< SAH partition,
    # diverging the two builders' topology.
    origin64 = np.asarray(origin, np.float64)
    u64 = np.asarray(u, np.float64)
    v64 = np.asarray(v, np.float64)
    pts = np.stack(
        [origin64, origin64 + u64, origin64 + v64,
         origin64 + u64 + v64], axis=1
    )
    centers = origin64 + 0.5 * (u64 + v64)

    prim_index = np.arange(n, dtype=np.int64)
    nodes_min: List[np.ndarray] = []
    nodes_max: List[np.ndarray] = []
    nodes_lf: List[int] = []
    nodes_ct: List[int] = []

    def node_bounds(lo: int, ct: int) -> tuple[np.ndarray, np.ndarray]:
        p = pts[prim_index[lo:lo + ct]].reshape(-1, 3)
        return p.min(axis=0), p.max(axis=0)

    def alloc(lo: int, ct: int) -> int:
        bmin, bmax = node_bounds(lo, ct)
        nodes_min.append(bmin)
        nodes_max.append(bmax)
        nodes_lf.append(lo)
        nodes_ct.append(ct)
        return len(nodes_lf) - 1

    def best_split(lo: int, ct: int) -> tuple[float, int, float]:
        """Vectorized sweep equivalent of the reference candidate loop
        (`main.rs:118-129`). Returns (best_cost, best_axis, best_pos)."""
        idx = prim_index[lo:lo + ct]
        c = centers[idx]            # [k, 3] in iteration order
        p = pts[idx]                # [k, 3, 3]
        best_cost = BIG
        best_axis, best_pos = 6, 0.0
        for axis in range(3):
            order = np.argsort(c[:, axis], kind="stable")
            sc = c[order, axis]
            sp = p[order]                                    # [k, 3pts, 3]
            lo_pts = np.minimum.reduce(sp, axis=1)           # [k, 3]
            hi_pts = np.maximum.reduce(sp, axis=1)
            pre_min = np.minimum.accumulate(lo_pts, axis=0)
            pre_max = np.maximum.accumulate(hi_pts, axis=0)
            suf_min = np.minimum.accumulate(lo_pts[::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(hi_pts[::-1], axis=0)[::-1]
            m = np.searchsorted(sc, c[:, axis], side="left")  # strict <
            area_l = np.where(m > 0, _half_area(pre_min[np.maximum(m - 1, 0)],
                                                pre_max[np.maximum(m - 1, 0)]), 0.0)
            area_r = np.where(m < ct, _half_area(suf_min[np.minimum(m, ct - 1)],
                                                 suf_max[np.minimum(m, ct - 1)]), 0.0)
            cost = m * area_l + (ct - m) * area_r
            cost = np.where((m == 0) | (m == ct), BIG, cost)   # empty side
            cost = np.where(cost > 0, cost, BIG)               # `main.rs:205-210`
            # `cost <= best_cost` keeps the latest candidate (`main.rs:123`),
            # i.e. the last occurrence of the minimum in iteration order.
            amin = float(cost.min())
            if amin <= best_cost:
                last_i = ct - 1 - int(np.argmin(cost[::-1]))
                best_cost = amin
                best_axis = axis
                best_pos = float(c[last_i, axis])
        return best_cost, best_axis, best_pos

    root = alloc(0, n)
    stack = [root]
    while stack:
        ni = stack.pop()
        lo, ct = nodes_lf[ni], nodes_ct[ni]
        if ct <= 1:
            continue
        best_cost, best_axis, best_pos = best_split(lo, ct)
        parent_cost = ct * _half_area(nodes_min[ni], nodes_max[ni])
        if best_cost > parent_cost:   # `main.rs:130-135`
            continue
        seg = prim_index[lo:lo + ct]
        left_mask = centers[seg, best_axis] < best_pos
        left_ct = int(left_mask.sum())
        if left_ct == 0 or left_ct == ct:  # `main.rs:159-161`
            continue
        prim_index[lo:lo + ct] = np.concatenate([seg[left_mask], seg[~left_mask]])
        li = alloc(lo, left_ct)
        ri = alloc(lo + left_ct, ct - left_ct)
        nodes_lf[ni] = li
        nodes_ct[ni] = 0
        stack.append(ri)
        stack.append(li)

    return BVH(
        aabb_min=np.stack(nodes_min).astype(np.float32),
        aabb_max=np.stack(nodes_max).astype(np.float32),
        left_first=np.array(nodes_lf, dtype=np.int32),
        count=np.array(nodes_ct, dtype=np.int32),
        prim_index=prim_index.astype(np.int32),
    )
