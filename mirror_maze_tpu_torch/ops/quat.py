"""Quaternion ops, layout (x, y, z, w), batched over leading axes
(counterpart of the JAX package's ``ops/quat.py``).

Rotation convention as the reference: v is rotated by ``(q^-1 * v * q).xyz``
with the Hamilton product (`maths.rs:139-178`, `shaders.metal:159-172`).
"""

from __future__ import annotations

import torch

from .vecmath import cross, dot, norm, normalize, sqrt


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn evaluated in float64 and rounded once to x's dtype: the correctly
    rounded value (nearly always), the same on every device. PyTorch's
    float32 sin/cos can be an ulp off it, and an ulp of the camera's w
    moves acos(w) by ~1e-6 near w = 1. These run on a handful of scalars
    per frame."""
    return fn(x.double()).to(x.dtype)


def hamilton(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (x, y, z, w) layout (`maths.rs:169-173`)."""
    v1, w1 = q1[..., :3], q1[..., 3]
    v2, w2 = q2[..., :3], q2[..., 3]
    s = w1 * w2 - dot(v1, v2)
    v = cross(v1, v2) + w1[..., None] * v2 + w2[..., None] * v1
    return torch.cat([v, s[..., None]], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate (`maths.rs:165-167`)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def rotate(vec: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate a 3-vector by q: ``(q^-1 * v * q).xyz`` (`maths.rs:175-178`)."""
    v4 = torch.cat([vec, torch.zeros_like(vec[..., :1])], dim=-1)
    return hamilton(hamilton(conjugate(q), v4), q)[..., :3]


def from_look_dir(look: torch.Tensor) -> torch.Tensor:
    """Quaternion from a camera look direction (`maths.rs:139-156`),
    including the reference's ``asin(|axis|) / 2`` half angle. A look
    exactly along the forward axis has a zero rotation axis; its
    denominator is guarded so it yields the identity instead of NaN."""
    default = torch.tensor([0.0, 0.0, 1.0], dtype=look.dtype, device=look.device)
    look_n = normalize(look)
    axis = cross(default.expand(look_n.shape), look_n)
    mag = norm(axis)
    axis_n = axis / torch.where(mag > 0, mag, torch.ones_like(mag))[..., None]
    half_theta = _rounded(torch.asin, mag) / 2.0
    s = _rounded(torch.sin, half_theta)[..., None]
    c = _rounded(torch.cos, half_theta)[..., None]
    return torch.cat([axis_n * s, c], dim=-1)


def aim(look: torch.Tensor) -> torch.Tensor:
    """Exact roll-free look-at quaternion (the JAX package's ``aim``; no
    reference twin): pitch about local x to the look's elevation, then yaw
    about world y to its azimuth, so ``rotate((0, 0, 1), aim(v))`` is
    ``normalize(v)`` and the right axis stays horizontal. A zero look gives
    the identity. The angles and their half-angle sines and cosines are
    evaluated in float64 and rounded once."""
    mag = norm(look)[..., None]
    forward = torch.zeros_like(look)
    forward[..., 2] = 1.0
    look_n = torch.where(mag > 0, look / torch.where(mag > 0, mag, torch.ones_like(mag)),
                         forward)
    lx, ly, lz = look_n[..., 0], look_n[..., 1], look_n[..., 2]
    yaw = torch.atan2(-lx.double(), lz.double()).float()
    pitch = _rounded(torch.asin, torch.clamp(ly, -1.0, 1.0))
    zeros = torch.zeros_like(yaw)
    q_pitch = torch.stack([_rounded(torch.sin, pitch / 2), zeros, zeros,
                           _rounded(torch.cos, pitch / 2)], dim=-1)
    q_yaw = torch.stack([zeros, _rounded(torch.sin, yaw / 2), zeros,
                         _rounded(torch.cos, yaw / 2)], dim=-1)
    return hamilton(q_pitch, q_yaw)


def update_angle(q: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Re-aim a yaw quaternion at half-angle theta, keeping its axis
    (`maths.rs:159-162`). Uses |xyz| where the reference uses
    sin(acos(w)) — equal for a unit quaternion and free of the inf that
    the reference's form produces near w = +-1 (see the JAX package)."""
    xyz = q[..., :3]
    mag = sqrt(dot(xyz, xyz))
    ratio = _rounded(torch.sin, theta) / mag
    return torch.cat([xyz * ratio[..., None], _rounded(torch.cos, theta)[..., None]], dim=-1)


def half_theta_of(q: torch.Tensor) -> torch.Tensor:
    """The yaw half-angle tracked by the reference host loop (`main.rs:741`)."""
    return _rounded(torch.acos, q[..., 3])
