"""Vector math over trailing-axis-3 tensors (counterpart of the JAX package's
``ops/vecmath.py``; the reference's `maths.rs:1-136`).

Sums run left to right over x, y, z, the order the JAX reductions use, so
the results agree bitwise where the elementwise rounding does.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis (`maths.rs:105-107`)."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector cross product (`maths.rs:130-136`)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def norm(a: torch.Tensor) -> torch.Tensor:
    """Euclidean magnitude over the trailing axis (`maths.rs:21-23`)."""
    return torch.sqrt(dot(a, a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector (`maths.rs:24-26`); divides by zero for zero input, as
    the reference does."""
    return a / norm(a)[..., None]
