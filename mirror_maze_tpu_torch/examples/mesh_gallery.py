"""Triangle meshes on the mirror-maze engine — the mesh showcase
(counterpart of the JAX package's ``examples/mesh_gallery.py``).

The reference renders exactly one primitive: the quad
(`shaders.metal:51-67`). The engine adds TRIANGLES (Scene.kind == 3, the
tracer's test mode 4) and a mesh toolkit (``scene/mesh.py``): vertex/face
arrays, a geodesic icosphere, Wavefront OBJ load/save, and scene merging.
This example assembles a small white room and places three meshes in it:

- a MIRROR icosphere (320 triangles) — curved reflections from flat
  triangles, the classic mesh stress test;
- a diffuse "gem" (a coarse icosahedron, rotated) with warm emission;
- the same gem round-tripped through an OBJ file (load_obj(save_obj(x))),
  proving the interchange path renders identically.

Run (writes mesh_gallery.npz + mesh_gallery.png; on the CUDA card unless
--device cpu):
    python -m mirror_maze_tpu_torch.examples.mesh_gallery [--size 256] \
        [--spp 64] [--intersector pallas] [--out mesh_gallery.png]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..scene.builder import Scene
from .cornell_box import add_render_flags, render_config, render_scene

WHITE = (0.73, 0.71, 0.68)
FLOOR_Y, CEIL_Y = 2.0, -8.0          # engine convention: +y is DOWN
HALF, Z_MIN, Z_MAX = 6.0, -11.0, 5.0
LIGHT = (1.0, 0.85, 0.55, 30.0)


def _room() -> Scene:
    """Six diffuse quads + one ceiling light panel (kind 0)."""
    rows = []

    def quad(origin, v, u, color, emission=(0, 0, 0, 0)):
        rows.append((origin, v, u, color, emission))

    depth, up = Z_MAX - Z_MIN, (0.0, CEIL_Y - FLOOR_Y, 0.0)
    quad((-HALF, FLOOR_Y, Z_MIN), (0, 0, depth), (2 * HALF, 0, 0), WHITE)
    quad((-HALF, CEIL_Y, Z_MIN), (2 * HALF, 0, 0), (0, 0, depth), WHITE)
    quad((-HALF, FLOOR_Y, Z_MAX), up, (2 * HALF, 0, 0), WHITE)
    quad((-HALF, FLOOR_Y, Z_MIN), up, (2 * HALF, 0, 0), WHITE)
    quad((-HALF, FLOOR_Y, Z_MIN), up, (0, 0, depth), (0.62, 0.08, 0.06))
    quad((HALF, FLOOR_Y, Z_MIN), (0, 0, depth), up, (0.12, 0.43, 0.09))
    quad((-2.5, CEIL_Y + 0.01, -2.5), (0, 0, 5.0), (5.0, 0, 0),
         (0.0, 0.0, 0.0), LIGHT)
    o, v, u, c, e = zip(*rows)
    return Scene(
        origin=np.asarray(o, np.float32),
        v=np.asarray(v, np.float32),
        u=np.asarray(u, np.float32),
        color=np.asarray(c, np.float32),
        is_mirror=np.zeros(len(rows), bool),
        emission=np.asarray(e, np.float32),
        grid=np.zeros((1, 1), np.uint8),
    )


def build_mesh_gallery() -> Scene:
    """Room + mirror icosphere + two gems (one via an OBJ round-trip)."""
    from ..scene.mesh import (
        icosphere,
        load_obj,
        merge_scenes,
        mesh_scene,
        save_obj,
        transform_vertices,
    )

    r_sph = 2.0
    sv, sf = icosphere(subdivisions=2, radius=r_sph,
                       center=(-2.4, FLOOR_Y - r_sph, 1.2))
    mirror_ball = mesh_scene(sv, sf, color=(0.0, 0.0, 0.0),
                             is_mirror=True)

    gv, gf = icosphere(subdivisions=0, radius=1.4)
    gv = transform_vertices(gv, rotate_y_deg=20.0,
                            translate=(2.6, FLOOR_Y - 1.5, -1.8))
    gem = mesh_scene(gv, gf, color=(0.9, 0.55, 0.15),
                     emission=(1.0, 0.6, 0.2, 0.25))

    # The second gem goes through the OBJ interchange path.
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "gem.obj")
        save_obj(p, gv, gf)
        ov, of = load_obj(p)
    gem2 = mesh_scene(
        transform_vertices(ov, scale=0.7, rotate_y_deg=-35.0,
                           translate=(-2.2, 0.0, -3.4)),
        of, color=(0.25, 0.5, 0.9),
    )
    return merge_scenes(_room(), mirror_ball, gem, gem2)


def main(argv=None) -> int:
    from ..scene import save_scene
    from ..utils.imageio import write_png

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_render_flags(p, "mesh_gallery.png", "mesh_gallery.npz")
    args = p.parse_args(argv)

    scene = build_mesh_gallery()
    if args.save_scene:
        save_scene(args.save_scene, scene)
        print(f"wrote {args.save_scene} ({scene.num_planes} planes, "
              f"{int((scene.kind == 3).sum())} triangles)")
    cfg = render_config(args.size, args.spp, args.intersector)
    write_png(args.out, render_scene(scene, cfg, args.device))
    print(f"wrote {args.out} ({args.size}x{args.size}, {args.spp} spp, "
          f"{args.intersector})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
