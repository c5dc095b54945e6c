"""Scene persistence: .npz round-trip for plane-soup scenes (a copy of
the JAX package's ``scene/io.py``, field for field, so that a file written
by either package loads in the other).

The reference has no scene IO at all — its world exists only as the
seed-0 maze rebuilt at every launch (`main.rs:356-588`). Here `Scene` is
a public surface: any quad soup drives the full engine, so scenes have the
same lossless .npz story the engine state has (`runtime/state.py
save_state`/`load_state`). A scene written by `save_scene` reloads
bit-exactly and renders identically on any host.
"""

from __future__ import annotations

import numpy as np

from .builder import Scene

# Per-plane fields with their canonical dtype and trailing shape.
_PLANE_FIELDS = (
    ("origin", np.float32, (3,)),
    ("v", np.float32, (3,)),
    ("u", np.float32, (3,)),
    ("color", np.float32, (3,)),
    ("is_mirror", np.bool_, ()),
    ("emission", np.float32, (4,)),
    ("kind", np.uint8, ()),
    ("ior", np.float32, ()),
    ("tex_kind", np.uint8, ()),
    ("tex_scale", np.float32, ()),
    ("tex_color2", np.float32, (3,)),
)

# Optional-on-load plane fields (pre-feature archives lack them and get
# the Scene.__post_init__ default — all-opaque for ior, untextured).
_OPTIONAL_PLANE = ("kind", "ior", "tex_kind", "tex_scale", "tex_color2")

# Per-sphere fields (all optional as a block: pre-sphere archives load
# with zero spheres, and sphere-free scenes write no sphere arrays, so
# files round-trip compatibly in both directions).
_SPHERE_FIELDS = (
    ("sph_center", np.float32, (3,)),
    ("sph_radius", np.float32, ()),
    ("sph_color", np.float32, (3,)),
    ("sph_is_mirror", np.bool_, ()),
    ("sph_emission", np.float32, (4,)),
    ("sph_ior", np.float32, ()),
    ("sph_tex_kind", np.uint8, ()),
    ("sph_tex_scale", np.float32, ()),
    ("sph_tex_color2", np.float32, (3,)),
)

# Optional-on-load sphere fields (pre-dielectric/texture archives).
_OPTIONAL_SPHERE = ("sph_ior", "sph_tex_kind", "sph_tex_scale",
                    "sph_tex_color2")


def save_scene(path: str, scene: Scene) -> None:
    """Write a scene (generated or hand-built) to a compressed .npz."""
    sphere = (
        {
            name: np.asarray(getattr(scene, name), dtype=dt)
            for name, dt, _ in _SPHERE_FIELDS
        }
        if scene.num_spheres else {}
    )
    np.savez_compressed(
        path,
        grid=np.asarray(scene.grid),
        **{
            name: np.asarray(getattr(scene, name), dtype=dt)
            for name, dt, _ in _PLANE_FIELDS
        },
        **sphere,
    )


def load_scene(path: str) -> Scene:
    """Load a scene written by ``save_scene`` (bit-exact round-trip).

    Validates per-plane shapes up front so a wrong/stale file fails here
    with a clear message instead of as an opaque shape error inside
    ``upload_scene``'s table packing. ``kind``/``grid`` are optional so
    hand-assembled archives of just the six plane arrays also load
    (kind defaults to the always-correct unspecialized full test,
    Scene.__post_init__; grid to an empty minimap).
    """
    with np.load(path) as z:
        required = [
            n for n, _, _ in _PLANE_FIELDS if n not in _OPTIONAL_PLANE
        ]
        missing = [n for n in required if n not in z]
        if missing:
            raise ValueError(
                f"scene file {path!r} lacks field(s) {missing} — not a "
                "save_scene archive (or from an incompatible version)"
            )
        n = z["origin"].shape[0]
        arrays = {}
        for name, dt, trail in _PLANE_FIELDS:
            if name in _OPTIONAL_PLANE and name not in z:
                continue
            a = np.asarray(z[name], dtype=dt)
            if a.shape != (n, *trail):
                raise ValueError(
                    f"scene file {path!r}: field {name!r} has shape "
                    f"{a.shape}, want {(n, *trail)} (n={n} planes from "
                    "'origin')"
                )
            arrays[name] = a
        if "sph_center" in z:
            s = z["sph_center"].shape[0]
            for name, dt, trail in _SPHERE_FIELDS:
                if name in _OPTIONAL_SPHERE and name not in z:
                    continue
                if name not in z:
                    raise ValueError(
                        f"scene file {path!r} has spheres but lacks "
                        f"{name!r} — not a save_scene archive"
                    )
                a = np.asarray(z[name], dtype=dt)
                if a.shape != (s, *trail):
                    raise ValueError(
                        f"scene file {path!r}: field {name!r} has shape "
                        f"{a.shape}, want {(s, *trail)} (s={s} spheres "
                        "from 'sph_center')"
                    )
                arrays[name] = a
        grid = (
            np.asarray(z["grid"], dtype=np.uint8)
            if "grid" in z else np.zeros((1, 1), np.uint8)
        )
    return Scene(grid=grid, **arrays)
