"""Random sampling primitives (counterpart of the JAX package's
``ops/sampling.py``): the diffuse scatter's unit vectors and the camera
jitter."""

from __future__ import annotations

import torch

from . import prng
from .vecmath import sqrt


def ray_jitter(key: torch.Tensor, shape: tuple, scale: float) -> torch.Tensor:
    """Anti-aliasing direction jitter: uniform in [-1, 1)^2 x {0}, scaled
    (`shaders.metal:303`: ((rand-0.5)*2, (rand-0.5)*2, 0) * 0.001)."""
    u = prng.uniform(key, shape + (2,), minval=-1.0, maxval=1.0)
    z = torch.zeros(shape + (1,), dtype=torch.float32, device=key.device)
    return torch.cat([u, z], dim=-1) * scale


def unit_sphere(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Uniform random unit vectors [*shape, 3] (batch + shape for keys
    [*batch, 2]): normalized Gaussian triples (`shaders.metal:315-319`
    rejection-samples the cube instead). The squared length is summed as
    XLA-CPU contracts it, fma(z, z, fma(y, y, x * x)), each FMA rounded
    once from float64."""
    return unit_from_normals(prng.normal(key, shape + (3,)))


def unit_from_normals(g: torch.Tensor) -> torch.Tensor:
    """``unit_sphere`` from its Gaussian triples g [..., 3] (the draw made):
    g over its length, the squared length summed as fma(z, z, fma(y, y,
    x * x)). The shade kernel (csrc/shade.cu) does the same for the rays it
    scatters."""
    x, y, z = g[..., 0], g[..., 1], g[..., 2]
    sq = prng.fma(z, z, prng.fma(y, y, x * x))
    return g / torch.clamp_min(sqrt(sq), 1e-12)[..., None]
