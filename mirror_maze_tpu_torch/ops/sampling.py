"""Random sampling primitives (counterpart of the JAX package's
``ops/sampling.py``)."""

from __future__ import annotations

import torch

from . import prng


def ray_jitter(key: torch.Tensor, shape: tuple, scale: float) -> torch.Tensor:
    """Anti-aliasing direction jitter: uniform in [-1, 1)^2 x {0}, scaled
    (`shaders.metal:303`: ((rand-0.5)*2, (rand-0.5)*2, 0) * 0.001)."""
    u = prng.uniform(key, shape + (2,), minval=-1.0, maxval=1.0)
    z = torch.zeros(shape + (1,), dtype=torch.float32, device=key.device)
    return torch.cat([u, z], dim=-1) * scale
