"""Top-down minimap of a Scene (host-side rasterizer).

The reference has no map view — players navigate the mirror maze blind
(README.md's stated design). This utility draws the world's actual
geometry from the Scene arrays: wall runs as lines (diffuse grey,
MIRROR cyan, GLASS pale blue), light panels warm, spheres as circles,
plus an optional camera position/facing marker. Pure NumPy at init-time
scale (a few hundred segments) — no device work, no dependencies.

A top-down RENDER cannot produce this view: +y points down, the ceiling
(kind 2) caps the world, and walls are zero-thickness vertical quads —
edge-on and invisible from above. Drawing the scene arrays directly is
the honest map.

A copy of the JAX package's ``utils/minimap.py``; the camera marker's
facing comes from the port's quaternion rotate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import quat as quat_ops

# Colors (RGB uint8).
BG = (18, 18, 22)
WALL = (150, 155, 165)
MIRROR = (80, 220, 230)
GLASS = (150, 190, 240)
LIGHT = (255, 200, 80)
BOUNDARY = (90, 90, 100)
CAMERA = (255, 80, 80)
SPHERE = (180, 140, 220)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a NumPy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _draw_line(img: np.ndarray, x0: float, y0: float, x1: float, y1: float,
               color, thick: int = 1) -> None:
    """Rasterize a segment by dense parametric sampling (init-time scale;
    simpler than Bresenham and exact enough at 2 samples/pixel)."""
    h, w, _ = img.shape
    n = max(2, int(2 * max(abs(x1 - x0), abs(y1 - y0))) + 1)
    ts = np.linspace(0.0, 1.0, n)
    xs = np.clip((x0 + (x1 - x0) * ts).round().astype(int), 0, w - 1)
    ys = np.clip((y0 + (y1 - y0) * ts).round().astype(int), 0, h - 1)
    for dy in range(-(thick // 2), thick - thick // 2):
        for dx in range(-(thick // 2), thick - thick // 2):
            img[np.clip(ys + dy, 0, h - 1), np.clip(xs + dx, 0, w - 1)] = color


def _draw_disc(img: np.ndarray, x: float, y: float, r: float, color) -> None:
    h, w, _ = img.shape
    yy, xx = np.mgrid[0:h, 0:w]
    img[(xx - x) ** 2 + (yy - y) ** 2 <= r * r] = color


def render_minimap(
    scene,
    size: int = 512,
    camera_center=None,
    camera_quat=None,
    margin: float = 0.04,
) -> np.ndarray:
    """Rasterize the scene's top-down layout into [size, size, 3] uint8.

    World x maps to image x, world z to image y (north = -z at the top,
    matching the spawn camera's initial look direction +z pointing DOWN
    the image — the view you would draw standing at spawn). Walls are
    classified by their Scene rows: emission strength > 0 draws as a
    LIGHT, ior > 0 as GLASS, is_mirror as MIRROR, kind 2 (world-closing)
    as the dim BOUNDARY, everything else as WALL. Spheres draw as
    circles at their centers. ``camera_center``/``camera_quat`` add a
    position disc and a facing tick (the quat's yaw applied to the
    reference +z forward).
    """
    origin = np.asarray(scene.origin, np.float64)
    v = np.asarray(scene.v, np.float64)
    u = np.asarray(scene.u, np.float64)
    em = np.asarray(scene.emission, np.float64)
    mirror = np.asarray(scene.is_mirror, bool)
    ior = np.asarray(scene.ior, np.float64) if scene.ior is not None else \
        np.zeros(origin.shape[0])
    kind = np.asarray(scene.kind, np.int32) if scene.kind is not None else \
        np.zeros(origin.shape[0], np.int32)

    # Horizontal footprint of each quad: project its corners to (x, z).
    # Vertical quads (walls/lights) become segments; horizontal ones
    # (floor/ceiling) collapse to their outline — skip those (kind 2 with
    # zero xz extent of one edge draws as the world border instead).
    corners = np.stack(
        [origin, origin + v, origin + u, origin + v + u], axis=1
    )[..., [0, 2]]                                          # [N, 4, (x,z)]
    lo = corners.min(axis=(0, 1))
    hi = corners.max(axis=(0, 1))
    span = float(max(hi[0] - lo[0], hi[1] - lo[1]))
    pad = margin * span
    scale = (size - 1) / (span + 2 * pad)

    def to_px(xz):
        return ((xz[..., 0] - lo[0] + pad) * scale,
                (xz[..., 1] - lo[1] + pad) * scale)

    img = np.empty((size, size, 3), np.uint8)
    img[:] = BG

    # Draw order: boundary, walls, glass, mirrors, lights (later wins).
    order = np.argsort(
        np.where(em[:, 3] > 0.0, 4,
                 np.where(mirror, 3, np.where(ior > 0.0, 2,
                          np.where(kind == 2, 0, 1)))),
        kind="stable",
    )
    for i in order:
        c = corners[i]
        # Segment endpoints: the two most distant footprint corners.
        d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        a, b = np.unravel_index(np.argmax(d2), d2.shape)
        if d2[a, b] < 1e-12:
            continue  # zero-footprint (degenerate runs)
        # Floor/ceiling cover the world: skip their interior (kind 2
        # horizontals have BOTH edges horizontal -> area footprint).
        # Scalar z-component of the 2-D cross product (np.cross on 2-D
        # inputs is deprecated in NumPy 2.0).
        cross_z = v[i, 0] * u[i, 2] - v[i, 2] * u[i, 0]
        if abs(cross_z) > 1e-9:
            continue
        if em[i, 3] > 0.0:
            color, thick = LIGHT, 3
        elif ior[i] > 0.0:
            color, thick = GLASS, 2
        elif mirror[i]:
            color, thick = MIRROR, 2
        elif kind[i] == 2:
            color, thick = BOUNDARY, 1
        else:
            color, thick = WALL, 2
        x0, y0 = to_px(c[a])
        x1, y1 = to_px(c[b])
        _draw_line(img, x0, y0, x1, y1, color, thick)

    if scene.num_spheres:
        centers = np.asarray(scene.sph_center, np.float64)[:, [0, 2]]
        radii = np.asarray(scene.sph_radius, np.float64)
        for c, r in zip(centers, radii):
            x, y = to_px(c)
            _draw_disc(img, x, y, max(2.0, r * scale), SPHERE)

    if camera_center is not None:
        cc = np.asarray(_host(camera_center), np.float64)[[0, 2]]
        x, y = to_px(cc)
        _draw_disc(img, x, y, max(3.0, 0.006 * size), CAMERA)
        if camera_quat is not None:
            fwd = quat_ops.rotate(torch.tensor([0.0, 0.0, 1.0]),
                                  torch.as_tensor(_host(camera_quat), dtype=torch.float32)
                                  ).numpy()[[0, 2]]
            n = np.linalg.norm(fwd)
            if n > 1e-6:
                fwd = fwd / n * 0.03 * size
                _draw_line(img, x, y, x + fwd[0], y + fwd[1], CAMERA, 2)
    return img
