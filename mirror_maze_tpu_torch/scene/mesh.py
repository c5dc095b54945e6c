"""Triangle meshes as first-class scenes (a copy of the JAX package's
``scene/mesh.py``, host NumPy only).

The reference's only primitive is the quad (`shaders.metal:51-67` tests a
parallelogram; every world it can draw is its seeded maze). This module
goes beyond parity: any triangle mesh — hand-built vertex/face arrays, a
procedural icosphere, or a Wavefront OBJ file — becomes a `Scene` whose
triangles (Scene.kind == 3) the fused tracer tests as its modes 4 (opaque)
and 7 (glass) (render/fused_tracer.py, csrc/tracer.cu).

Conventions:
- A face (i0, i1, i2) becomes origin = V[i0], v = V[i1] - V[i0],
  u = V[i2] - V[i0], so the engine normal normalize(cross(v, u)) is the
  standard outward normal of counterclockwise winding — OBJ meshes
  mirror-reflect from outside without fixups.
- Engine worlds have +y pointing DOWN (scene/builder.py); most OBJ
  assets are modeled +y up. ``load_obj(..., y_down=True)`` (default)
  negates y and swaps the face winding so outward stays outward.
"""

from __future__ import annotations

import numpy as np

from .builder import Scene


def mesh_scene(
    vertices: np.ndarray,          # [V, 3] float
    faces: np.ndarray,             # [F, 3] int vertex indices
    *,
    color=(0.7, 0.7, 0.7),         # [3] or [F, 3] albedo
    is_mirror=False,               # bool or [F] bool
    emission=(0.0, 0.0, 0.0, 0.0),  # [4] or [F, 4] rgb + strength
    ior=0.0,                       # float or [F]: 0 opaque, > 0 glass
    grid: np.ndarray | None = None,
) -> Scene:
    """Build a triangle-soup Scene (kind 3) from vertex/face arrays.

    ``color``/``is_mirror``/``emission`` broadcast from scalars-per-mesh
    to per-face arrays. Degenerate faces (zero area, repeated indices)
    are allowed — SceneDerived marks them invalid and every backend
    ignores them, same as the generated maze's zero-extent wall runs.
    """
    verts = np.asarray(vertices, np.float32)
    f = np.asarray(faces)
    if verts.ndim != 2 or verts.shape[1] != 3:
        raise ValueError(f"vertices must be [V, 3], got {verts.shape}")
    if f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"faces must be [F, 3], got {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= verts.shape[0]):
        raise ValueError(
            f"face indices out of range [0, {verts.shape[0]}): "
            f"min {f.min()}, max {f.max()}"
        )
    n = f.shape[0]
    v0 = verts[f[:, 0]]
    col = np.broadcast_to(
        np.asarray(color, np.float32), (n, 3)
    ).copy()
    mir = np.broadcast_to(np.asarray(is_mirror, bool), (n,)).copy()
    em = np.broadcast_to(
        np.asarray(emission, np.float32), (n, 4)
    ).copy()
    return Scene(
        origin=v0,
        v=verts[f[:, 1]] - v0,
        u=verts[f[:, 2]] - v0,
        color=col,
        is_mirror=mir,
        emission=em,
        grid=grid if grid is not None else np.zeros((1, 1), np.uint8),
        kind=np.full(n, 3, np.uint8),
        ior=np.broadcast_to(np.asarray(ior, np.float32), (n,)).copy(),
    )


def merge_scenes(*scenes: Scene) -> Scene:
    """Concatenate plane soups (and spheres) into one Scene.

    Quads, triangles, and spheres mix freely — each plane keeps its own
    kind. The minimap grid comes from the first scene that has a
    non-empty one (purely cosmetic; tests/minimap only).
    """
    if not scenes:
        raise ValueError("merge_scenes needs at least one scene")
    cat = lambda name: np.concatenate(
        [np.asarray(getattr(s, name)) for s in scenes], axis=0
    )
    grid = next(
        (s.grid for s in scenes if np.asarray(s.grid).size > 1),
        scenes[0].grid,
    )
    return Scene(
        origin=cat("origin"), v=cat("v"), u=cat("u"), color=cat("color"),
        is_mirror=cat("is_mirror"), emission=cat("emission"), grid=grid,
        kind=cat("kind"), ior=cat("ior"),
        tex_kind=cat("tex_kind"), tex_scale=cat("tex_scale"),
        tex_color2=cat("tex_color2"),
        sph_center=cat("sph_center"), sph_radius=cat("sph_radius"),
        sph_color=cat("sph_color"), sph_is_mirror=cat("sph_is_mirror"),
        sph_emission=cat("sph_emission"), sph_ior=cat("sph_ior"),
        sph_tex_kind=cat("sph_tex_kind"),
        sph_tex_scale=cat("sph_tex_scale"),
        sph_tex_color2=cat("sph_tex_color2"),
    )


def transform_vertices(
    vertices: np.ndarray,
    *,
    scale: float = 1.0,
    rotate_y_deg: float = 0.0,
    translate=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """Uniform scale, then yaw about +y, then translate (float64 math,
    rounded once). Uniform scale + rotation preserve winding, so face
    arrays need no change."""
    v = np.asarray(vertices, np.float64) * float(scale)
    if rotate_y_deg:
        a = np.deg2rad(float(rotate_y_deg))
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
        v = v @ rot.T
    return (v + np.asarray(translate, np.float64)).astype(np.float32)


def icosphere(subdivisions: int = 2, radius: float = 1.0,
              center=(0.0, 0.0, 0.0)):
    """Geodesic sphere: icosahedron subdivided ``subdivisions`` times,
    vertices projected to the sphere. Returns (vertices [V, 3] f32,
    faces [F, 3] i32) with outward counterclockwise winding;
    F = 20 * 4**subdivisions."""
    if subdivisions < 0:
        raise ValueError("subdivisions must be >= 0")
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        vlist = list(verts)
        midpoint: dict[tuple[int, int], int] = {}

        def mid(i, j):
            key = (i, j) if i < j else (j, i)
            if key not in midpoint:
                m = vlist[i] + vlist[j]
                vlist.append(m / np.linalg.norm(m))
                midpoint[key] = len(vlist) - 1
            return midpoint[key]

        out = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(out, np.int64)
    verts = verts * float(radius) + np.asarray(center, np.float64)
    return verts.astype(np.float32), faces.astype(np.int32)


def load_obj(path: str, *, y_down: bool = True):
    """Minimal Wavefront OBJ reader: ``v`` and ``f`` records, 1-based
    and negative indices, ``f`` entries of the form i, i/t, i/t/n or
    i//n, polygons fan-triangulated; everything else (vt/vn/usemtl/
    groups/comments) is skipped. Returns (vertices [V, 3] float32,
    faces [F, 3] int32).

    ``y_down`` (default) converts the usual +y-up asset convention to
    the engine's +y-down world: y is negated and each face's winding is
    swapped so outward normals stay outward.
    """
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                if len(parts) < 4:
                    raise ValueError(
                        f"{path}:{lineno}: malformed vertex: {line!r}"
                    )
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    s = tok.split("/")[0]
                    i = int(s)
                    # OBJ is 1-based; negative counts from the end.
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                if len(idx) < 3:
                    raise ValueError(
                        f"{path}:{lineno}: face needs >= 3 vertices"
                    )
                for k in range(1, len(idx) - 1):   # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int32).reshape(-1, 3)
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError(f"{path}: face index out of range")
    if y_down:
        v = v * np.asarray([1.0, -1.0, 1.0], np.float32)
        f = f[:, [0, 2, 1]]
    return v, f


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
             *, y_down: bool = True) -> None:
    """Write (vertices, faces) as OBJ — the inverse of ``load_obj``
    (same ``y_down`` flag round-trips engine-space meshes)."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    if y_down:
        v = v * np.asarray([1.0, -1.0, 1.0], np.float32)
        f = f[:, [0, 2, 1]]
    with open(path, "w") as fh:
        fh.write("# mirror-maze-tpu mesh\n")
        for x, y, z in v:
            # Python-float repr round-trips the f32 value exactly
            # (f32 -> f64 is exact; repr(f64) is shortest-exact).
            fh.write(f"v {float(x)!r} {float(y)!r} {float(z)!r}\n")
        for a, b, c in f + 1:
            fh.write(f"f {a} {b} {c}\n")
