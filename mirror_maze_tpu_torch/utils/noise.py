"""Noise texture: the reference's RNG seed source (counterpart of the JAX
package's ``utils/noise.py``).

The reference seeds each GPU thread's PCG state from a sample of a 512x512
noise texture (`shaders.metal:288-300`, `main.rs:667-695`). With
``TracerConfig.noise_rng`` on, the engine mixes the pixel's sample into the
fused tracer's per-ray seed, which reproduces the reference's spatially
correlated grain.
"""

from __future__ import annotations

import numpy as np
import torch

NOISE_SIZE = 512


def generate_noise(size: int = NOISE_SIZE, seed: int = 0) -> np.ndarray:
    """Deterministic white-noise texture [size, size] float32 in [0, 1): a
    PCG-style integer hash of the pixel index (the mixing constants of the
    device RNG, `shaders.metal:181-186`)."""
    idx = np.arange(size * size, dtype=np.uint64) + np.uint64(seed) * np.uint64(
        0x9E3779B9
    )
    state = (idx.astype(np.uint32) * np.uint32(747796405)) + np.uint32(291336453)
    word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) * np.uint32(
        277803737
    )
    word = (word >> np.uint32(22)) ^ word
    return (word >> np.uint32(8)).astype(np.float32).reshape(size, size) / float(
        1 << 24
    )


def load_noise_png(path: str) -> np.ndarray:
    """A noise PNG (e.g. the reference's textures/noiseTexture-2.png) as
    [H, W] float32 in [0, 1): the red channel, the reference's
    single-component sample (`shaders.metal:289`)."""
    from .imageio import read_png

    img = read_png(path)
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float32) / 255.0


def sample_noise(tex: torch.Tensor, pixels_xy: torch.Tensor) -> torch.Tensor:
    """Per-pixel noise values [K] for pixel coords [K, 2] (x, y), with
    wrap-around addressing as a repeat-mode texture sampler."""
    h, w = tex.shape
    x = (pixels_xy[:, 0] % w).to(torch.int64)
    y = (pixels_xy[:, 1] % h).to(torch.int64)
    return tex[y, x]
