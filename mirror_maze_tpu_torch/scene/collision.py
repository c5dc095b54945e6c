"""Player-vs-world collision query (counterpart of the JAX package's
``scene/collision.py``).

The reference walks the BVH and reverts the camera on the first leaf box the
player's AABB overlaps (`main.rs:265-291, 817-826`). The same predicate is a
branchless any() over the precomputed leaf-box set: a box that overlaps a
leaf overlaps every ancestor, so pruning changes cost, not the answer.
"""

from __future__ import annotations

import torch


def collides(
    leaf_min: torch.Tensor,   # [L, 3]
    leaf_max: torch.Tensor,   # [L, 3]
    box_min: torch.Tensor,    # [..., 3]
    box_max: torch.Tensor,    # [..., 3]
) -> torch.Tensor:
    """True where the query box overlaps any leaf AABB (closed intervals on
    all three axes, `main.rs:237-244`). Batched over leading query dims."""
    bmin = box_min[..., None, :]
    bmax = box_max[..., None, :]
    overlap = ((bmin <= leaf_max) & (bmax >= leaf_min)).all(dim=-1)
    return overlap.any(dim=-1)
