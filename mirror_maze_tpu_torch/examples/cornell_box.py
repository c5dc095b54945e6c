"""Cornell box on the mirror-maze engine — a custom-scene showcase
(counterpart of the JAX package's ``examples/cornell_box.py``).

The reference app renders exactly one world: its seeded maze
(`main.rs:356-588`). The engine's `Scene` is a public surface: any quad soup
drives the full engine. This example assembles the classic Cornell box —
red/green side walls, white floor/ceiling/back, one warm area light, a short
diffuse block and a tall MIRROR block — saves it with `save_scene`, and
renders it offline.

Its albedos (0.725/0.63/0.065…) and rotated-block normals are not the
axis-aligned values of the generated maze, so the image exercises the
tracer on geometry the maze never produces.

World conventions (scene/builder.py): +y points DOWN — the room floor is
y = +2 and its ceiling y = -8, matching the engine's maze worlds so the
default player physics work unchanged.

Run (writes cornell.npz + cornell.png; on the CUDA card unless --device cpu):
    python -m mirror_maze_tpu_torch.examples.cornell_box [--size 256] \
        [--spp 64] [--intersector pallas] [--out cornell.png]

Or drive the saved world with the CLI:
    python -m mirror_maze_tpu_torch render --scene cornell.npz \
        --spawn 0,-3,-10 --look 0,0,1 --width 512 --height 512 --spp 64
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..scene.builder import Scene

# Classic Cornell albedos.
WHITE = (0.725, 0.71, 0.68)
RED = (0.63, 0.065, 0.05)
GREEN = (0.14, 0.45, 0.091)
LIGHT_RGB = (1.0, 0.85, 0.55)
LIGHT_STRENGTH = 34.0

FLOOR_Y = 2.0     # +y is down: floor below, ceiling above
CEIL_Y = -8.0
HALF = 5.0        # room spans [-5, 5] in x
Z_MIN = -10.5     # the room extends BEHIND the camera and is fully
Z_MAX = 5.0       # closed, so the mirror block reflects lit geometry
                  # instead of an open (black) front — and no ray ever
                  # escapes, like the engine's closed maze worlds
VARIANTS = ("blocks", "spheres", "glass")
# The camera of the render: at the room's front, looking along +z.
SPAWN = (0.0, -3.0, -10.0)


class _Soup:
    """Accumulates quads; `scene()` emits the SoA Scene."""

    def __init__(self):
        self.rows = []

    def quad(self, origin, v, u, color, mirror=False, emission=(0, 0, 0, 0)):
        """One parallelogram origin + a*v + b*u, (a, b) in [0,1]^2.

        Normal convention (scene/builder.py SceneDerived): unit
        normal = normalize(cross(v, u)). Mirrors reflect only on front
        faces, so mirror quads must face outward.
        """
        self.rows.append((origin, v, u, color, mirror, emission))

    def block(self, cx, cz, half_x, half_z, height, theta_deg,
              color, mirror=False):
        """An axis box rotated theta around y: 4 outward sides + top.

        No bottom face: it is coplanar with the floor and unreachable.
        """
        th = np.deg2rad(theta_deg)
        rot = np.array([[np.cos(th), np.sin(th)],
                        [-np.sin(th), np.cos(th)]])
        # Base corners ordered so each side's cross(v, u) points outward
        # (clockwise when seen from -y, i.e. from above).
        base = np.array([[-half_x, -half_z], [-half_x, half_z],
                         [half_x, half_z], [half_x, -half_z]]) @ rot.T
        base += (cx, cz)
        top_y = FLOOR_Y - height
        up = (0.0, -height, 0.0)
        for i in range(4):
            c0, c1 = base[i], base[(i + 1) % 4]
            self.quad(
                (c0[0], FLOOR_Y, c0[1]), up,
                (c1[0] - c0[0], 0.0, c1[1] - c0[1]), color, mirror,
            )
        # Top: v along c0->c3, u along c0->c1 makes cross(v, u) point -y
        # (up, out of the block).
        c0, c1, c3 = base[0], base[1], base[3]
        self.quad(
            (c0[0], top_y, c0[1]),
            (c3[0] - c0[0], 0.0, c3[1] - c0[1]),
            (c1[0] - c0[0], 0.0, c1[1] - c0[1]), color, mirror,
        )

    def scene(self) -> Scene:
        o, v, u, c, m, e = zip(*self.rows)
        return Scene(
            origin=np.asarray(o, np.float32),
            v=np.asarray(v, np.float32),
            u=np.asarray(u, np.float32),
            color=np.asarray(c, np.float32),
            is_mirror=np.asarray(m, bool),
            emission=np.asarray(e, np.float32),
            grid=np.zeros((1, 1), np.uint8),
        )


def checker_floor(scene: Scene, cells: float = 8.0, color2=(0.25, 0.25, 0.3)) -> Scene:
    """Turn the Cornell floor (plane 0) into a UV checker — the
    engine's procedural-texture surface (Scene.tex_kind 1)."""
    tex_kind = np.zeros(scene.num_planes, np.uint8)
    tex_scale = np.ones(scene.num_planes, np.float32)
    tex_color2 = np.zeros((scene.num_planes, 3), np.float32)
    tex_kind[0] = 1
    tex_scale[0] = cells
    tex_color2[0] = color2
    return dataclasses.replace(
        scene, tex_kind=tex_kind, tex_scale=tex_scale,
        tex_color2=tex_color2,
    )


def build_cornell_box(variant: str = "blocks") -> Scene:
    """The Cornell box as an engine `Scene`.

    variant="blocks": the classic two rotated boxes (17 quads).
    variant="spheres": a tall MIRROR sphere left-back and a diffuse white
    sphere right-front, both resting on the floor (`Scene.sph_*`
    primitives, the tracer's test mode 3).
    variant="glass": a GLASS sphere (ior 1.5, faint blue tint)
    center-front beside the tall mirror block: refraction and reflection
    in one image (test mode 5: Fresnel reflect/refract split,
    two-interface paths, far-root exits).
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    s = _Soup()
    height = FLOOR_Y - CEIL_Y                      # 10
    up = (0.0, -height, 0.0)
    # Room shell (diffuse — orientation is irrelevant for diffuse
    # surfaces, the scatter flips with the hit side like the reference).
    depth = Z_MAX - Z_MIN
    s.quad((-HALF, FLOOR_Y, Z_MIN), (0, 0, depth), (2 * HALF, 0, 0),
           WHITE)                                   # floor (index 0)
    s.quad((-HALF, CEIL_Y, Z_MIN), (2 * HALF, 0, 0), (0, 0, depth),
           WHITE)                                   # ceiling
    s.quad((-HALF, FLOOR_Y, Z_MAX), up, (2 * HALF, 0, 0), WHITE)  # back
    s.quad((-HALF, FLOOR_Y, Z_MIN), up, (2 * HALF, 0, 0), WHITE)  # front
    s.quad((-HALF, FLOOR_Y, Z_MIN), up, (0, 0, depth), RED)       # left
    s.quad((HALF, FLOOR_Y, Z_MIN), (0, 0, depth), up, GREEN)      # right
    # Area light: a panel just under the ceiling, centered.
    s.quad((-2.0, CEIL_Y + 0.01, -1.75), (0, 0, 3.5), (4.0, 0, 0),
           (0.0, 0.0, 0.0), emission=(*LIGHT_RGB, LIGHT_STRENGTH))
    if variant == "spheres":
        r_mirror, r_diff = 2.2, 1.5
        return dataclasses.replace(
            s.scene(),
            # Resting on the floor: +y is down, so center y = floor - r.
            sph_center=np.float32([[-2.0, FLOOR_Y - r_mirror, 1.8],
                                   [2.0, FLOOR_Y - r_diff, -1.7]]),
            sph_radius=np.float32([r_mirror, r_diff]),
            sph_color=np.float32([(0, 0, 0), WHITE]),  # mirror: no tint
            sph_is_mirror=np.array([True, False]),
            sph_emission=np.zeros((2, 4), np.float32),
            sph_ior=np.zeros(2, np.float32),
        )
    if variant == "glass":
        s.block(-2.0, 1.8, 1.5, 1.5, 6.0, 17.0, WHITE, mirror=True)
        r_glass = 1.8
        return dataclasses.replace(
            s.scene(),
            sph_center=np.float32([[1.6, FLOOR_Y - r_glass, -2.2]]),
            sph_radius=np.float32([r_glass]),
            sph_color=np.float32([(0.94, 0.97, 1.0)]),
            sph_is_mirror=np.array([False]),
            sph_emission=np.zeros((1, 4), np.float32),
            sph_ior=np.float32([1.5]),
        )
    # Short diffuse block (right-front), tall MIRROR block (left-back).
    s.block(2.0, -1.7, 1.5, 1.5, 3.0, -17.0, WHITE)
    s.block(-2.0, 1.8, 1.5, 1.5, 6.0, 17.0, WHITE, mirror=True)
    return s.scene()


def render_config(size: int, spp: int, intersector: str):
    """The examples' render configuration: the camera at SPAWN looking
    along +z, a square frame of ``size`` pixels at ``spp``."""
    from ..config import CameraConfig, EngineConfig, ScreenConfig

    return EngineConfig(
        camera=CameraConfig(spawn=SPAWN, look_dir=(0, 0, 1)),
        screen=ScreenConfig(width=size, height=size, samples_per_pixel=spp),
        intersector=intersector,
    )


def render_scene(scene: Scene, cfg, device) -> np.ndarray:
    """The uint8 display image of ``scene`` by ``render_full_frame`` at
    seed 0 on ``device`` (None = the CUDA card)."""
    from ..device import resolve_device
    from ..ops import prng
    from ..render import make_camera, render_full_frame, to_display, upload_scene

    dev = resolve_device(device)
    d_scene = upload_scene(scene, device=dev)
    cam = make_camera(cfg.camera, cfg.screen.width / cfg.screen.height, dev)
    img = render_full_frame(d_scene, cam, prng.PRNGKey(0, device=dev), cfg)
    return to_display(img).cpu().numpy()


def add_render_flags(p: argparse.ArgumentParser, out: str, save_scene: str) -> None:
    """The flags both offline examples share, with the JAX examples'
    defaults, plus ``--device``."""
    p.add_argument("--size", type=int, default=256, help="square image size")
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--intersector", default="brute",
                   choices=["brute", "bvh", "pallas"],
                   help="'pallas' is the fused CUDA tracer kernel, the others the jnp "
                        "tracer's backends")
    p.add_argument("--out", default=out)
    p.add_argument("--save-scene", default=save_scene)
    p.add_argument("--device", default=None,
                   help="device to run on (default: the CUDA card; fails without one. "
                        "'cpu' runs the plain PyTorch versions of the kernels)")


def main(argv=None) -> int:
    from ..scene import save_scene
    from ..utils.imageio import write_png

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_render_flags(p, "cornell.png", "cornell.npz")
    p.add_argument("--variant", default="blocks", choices=list(VARIANTS),
                   help="two rotated boxes (classic), the two-sphere "
                        "variant (mirror + diffuse spheres), or the "
                        "glass variant (dielectric sphere + mirror "
                        "block: Snell refraction with Schlick Fresnel)")
    p.add_argument("--checker", action="store_true",
                   help="checker the floor (procedural UV texture, "
                        "Scene.tex_kind 1)")
    args = p.parse_args(argv)

    scene = build_cornell_box(args.variant)
    if args.checker:
        scene = checker_floor(scene)
    if args.save_scene:
        save_scene(args.save_scene, scene)
        print(f"wrote {args.save_scene} ({scene.num_planes} planes, "
              f"{scene.num_spheres} spheres)")
    cfg = render_config(args.size, args.spp, args.intersector)
    write_png(args.out, render_scene(scene, cfg, args.device))
    print(f"wrote {args.out} ({args.size}x{args.size}, {args.spp} spp, "
          f"{args.intersector})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
