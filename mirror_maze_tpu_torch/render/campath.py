"""Camera paths for offline animation (counterpart of the JAX package's
``render/campath.py``): an in-place yaw spin, a look-at orbit and a
piecewise-linear waypoint flythrough, each a batched ``Camera`` (leading
axis = frame) rotated by the exact, roll-free ``quat.aim``, and
``render_path``, which renders every camera of a path to a display frame.

The reference's camera is driven live only (`main.rs:780-939`); these paths
are the JAX package's extension, ported function for function. Angles are
computed in float64 and rounded once.
"""

from __future__ import annotations

import math

import torch

from ..ops import quat as quat_ops
from ..ops import prng
from ..ops.vecmath import normalize
from .accumulate import to_display
from .camera import Camera
from .pipeline import render_full_frame, scene_nearest_fn


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(like.device)


def _batched(base: Camera, centers: torch.Tensor, looks: torch.Tensor) -> Camera:
    """A batched Camera from per-frame centres [N, 3] and look directions
    [N, 3], keeping the base camera's focal length and viewport."""
    n = centers.shape[0]
    return Camera(center=centers.float(), rotation=quat_ops.aim(looks.float()),
                  focal=base.focal.expand(n).clone(), viewport=base.viewport.expand(n, 2).clone())


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn in float64, rounded once to float32."""
    return fn(x.double()).float()


def _rounded2(fn, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return fn(x.double(), y.double()).float()


def _frac(n: int, like: torch.Tensor) -> torch.Tensor:
    """i / n for the frames i < n, float32 (the endpoint is exclusive, so a
    one-turn loop closes without a repeated frame)."""
    return torch.arange(n, dtype=torch.float32, device=like.device) / n


def spin_cameras(base: Camera, look0, n: int, turns: float = 1.0) -> Camera:
    """Yaw in place: ``turns`` revolutions about world y from the azimuth of
    ``look0``, keeping its elevation."""
    look0 = normalize(_f32(look0, base.center))
    azim0 = _rounded2(torch.atan2, -look0[0], look0[2])
    elev = _rounded(torch.asin, torch.clamp(look0[1], -1.0, 1.0))
    azim = azim0 + float(2.0 * math.pi * turns) * _frac(n, base.center)
    ce = _rounded(torch.cos, elev)
    looks = torch.stack([-_rounded(torch.sin, azim) * ce,
                         _rounded(torch.sin, elev).expand(n),
                         _rounded(torch.cos, azim) * ce], dim=-1)
    return _batched(base, base.center.expand(n, 3), looks)


def orbit_cameras(base: Camera, center, radius: float, height: float, n: int,
                  turns: float = 1.0) -> Camera:
    """Circle ``center`` at ``radius`` in the xz plane and ``height`` above
    it, always aiming at the centre."""
    c = _f32(center, base.center)
    theta = float(2.0 * math.pi * turns) * _frac(n, base.center)
    pos = c + torch.stack([radius * _rounded(torch.cos, theta),
                           torch.full_like(theta, float(height)),
                           radius * _rounded(torch.sin, theta)], dim=-1)
    return _batched(base, pos, c - pos)


def waypoint_cameras(base: Camera, points, n: int, target=None, looks=None) -> Camera:
    """Piecewise-linear flythrough of ``points`` [K, 3]: aimed at a fixed
    ``target``, or along the interpolated per-waypoint ``looks`` [K, 3], or
    else along the direction of travel."""
    pts = _f32(points, base.center)
    k = pts.shape[0]
    if k < 2:
        raise ValueError("a waypoint path needs at least 2 points")
    t = torch.arange(n, dtype=torch.float32, device=pts.device) / max(n - 1, 1) * (k - 1)
    seg = torch.clamp(t.to(torch.int64), 0, k - 2)
    frac = (t - seg.float())[:, None]
    p0, p1 = pts[seg], pts[seg + 1]
    pos = p0 * (1.0 - frac) + p1 * frac
    if target is not None:
        look = _f32(target, pos) - pos
    elif looks is not None:
        lk = _f32(looks, pos)
        look = lk[seg] * (1.0 - frac) + lk[seg + 1] * frac
    else:
        look = p1 - p0
    return _batched(base, pos, look)


def render_path(scene, cams: Camera, key: torch.Tensor, cfg):
    """Render every camera of the path: uint8 display frames [N, H, W, 3] on
    the scene's device. Frame i draws from ``split(key, N)[i]``, the keys of
    the reference's ``lax.map``; a jnp backend is built once for the path."""
    n = cams.center.shape[0]
    keys = prng.split(key, n)
    nearest_fn = scene_nearest_fn(scene, cfg)
    return torch.stack([
        to_display(render_full_frame(scene, Camera(*(x[i] for x in cams)), keys[i], cfg,
                                     nearest_fn=nearest_fn))
        for i in range(n)])
