"""Per-sample tone map (the part of the JAX package's ``render/tracer.py``
that the fused-kernel path uses)."""

from __future__ import annotations

import torch


def tone_map(light: torch.Tensor) -> torch.Tensor:
    """Per-sample gamma before averaging (`shaders.metal:344`):
    sqrt(max(light, 0))."""
    return torch.sqrt(torch.clamp_min(light, 0.0))
