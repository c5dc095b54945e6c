"""Pinhole camera and primary-ray generation (counterpart of the JAX
package's ``render/camera.py``; the reference's `main.rs:32-39, 732-747`
and `shaders.metal:281-284`). Pixel centers are not half-pixel offset —
the shader uses raw pixel.x/width, replicated."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraConfig
from ..ops import quat as quat_ops
from ..ops.vecmath import normalize, reciprocal


class Camera(NamedTuple):
    center: torch.Tensor    # [3]
    rotation: torch.Tensor  # [4] quaternion (x, y, z, w)
    focal: torch.Tensor     # [] scalar
    viewport: torch.Tensor  # [2] (width, height)


def make_camera(cfg: CameraConfig, aspect: float, device) -> Camera:
    """Initial camera from config (`main.rs:732-747`)."""
    f32 = dict(dtype=torch.float32, device=device)
    look = torch.tensor(cfg.look_dir, **f32)
    vh = cfg.viewport_height
    return Camera(
        center=torch.tensor(cfg.spawn, **f32),
        rotation=quat_ops.from_look_dir(look),
        focal=torch.tensor(cfg.focal_length, **f32),
        viewport=torch.tensor([vh * aspect, vh], **f32),
    )


def ray_directions(
    cam: Camera, pixels_xy: torch.Tensor, width: float, height: float
) -> torch.Tensor:
    """Primary ray directions [..., 3] for pixel coordinates [..., 2]:
    normalize((px/W*vw - vw/2, py/H*vh - vh/2, focal)), then rotated by
    the camera quaternion (`shaders.metal:281-284`). The divisions by W and
    H are multiplies by their float32 reciprocals, as XLA computes them
    under jit and torch on the card (the CPU would divide), so the
    directions are the same bits on every device; halving is exact."""
    p = pixels_xy.to(torch.float32)
    vw, vh = cam.viewport[0], cam.viewport[1]
    x = p[..., 0] * reciprocal(width) * vw - vw / 2.0
    y = p[..., 1] * reciprocal(height) * vh - vh / 2.0
    z = cam.focal.expand(x.shape)
    d = normalize(torch.stack([x, y, z], dim=-1))
    return quat_ops.rotate(d, cam.rotation.expand(d.shape[:-1] + (4,)))
