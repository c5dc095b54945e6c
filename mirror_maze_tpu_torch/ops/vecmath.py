"""Vector math over trailing-axis-3 tensors (counterpart of the JAX package's
``ops/vecmath.py``; the reference's `maths.rs:1-136`).

Sums run left to right over x, y, z, the order the JAX reductions use, so
the results agree bitwise where the elementwise rounding does.
"""

from __future__ import annotations

import numpy as np
import torch


def reciprocal(x: float) -> float:
    """The float32 reciprocal of x, correctly rounded: what torch on the card
    and XLA under jit multiply by where a float32 tensor is divided by the
    constant x (torch on the CPU divides)."""
    return float(np.float32(1.0) / np.float32(x))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device. PyTorch's
    CPU float32 sqrt is not correctly rounded (an ulp off on ~0.7% of
    inputs), CUDA's and XLA's are; the float64 root of a float32 value rounds
    to the correctly rounded float32 one."""
    return torch.sqrt(x.double()).to(x.dtype)


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
    return sqrt(dot(a, a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector (`maths.rs:24-26`); divides by zero for zero input, as
    the reference does."""
    return a / norm(a)[..., None]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Metal `reflect(d, n)` = d - 2*dot(d, n)*n (used at `shaders.metal:329`)."""
    return d - 2.0 * dot(d, n)[..., None] * n
