"""What the segment path's readers share: the patterns that find its three
kernels in the trace's ``by_kernel`` names, and a kernel's share of its
roofline, its bound a launch (``rec["rooflines"][kernel]``) over its mean
device time a launch in the traced window."""

from __future__ import annotations

import re

# A regular expression searched in a kernel's name, for each roofline: the
# walk, the shade, and the threefry kernel's normal instance (source IOTA,
# output NORMAL), not its fold_in instance.
PATTERNS = dict(bvh_walk=r"bvh_walk", shade=r"shade_kernel",
                normal_draw=r"threefry_kernel(<0, ?3>|ILi0ELi3E)")


def matching(by_kernel: dict, pattern: str) -> list:
    """The ``by_kernel`` entries whose name ``pattern`` is found in."""
    return [k for name, k in by_kernel.items() if re.search(pattern, name)]


def share(rec: dict, kernel: str, pattern: str) -> float | None:
    """The share in %; None where the run was not traced, its window
    launched no kernel of ``pattern`` (a regular expression searched in the
    kernel's name) or no roofline of ``kernel`` was counted."""
    t, r = rec.get("trace"), rec.get("rooflines", {}).get(kernel)
    if not t or not r:
        return None
    found = matching(t.get("by_kernel", {}), pattern)
    launches = sum(k["launches"] for k in found)
    if not launches:
        return None
    return r["bound_ms"] / (sum(k["seconds"] for k in found) * 1e3 / launches) * 100.0
