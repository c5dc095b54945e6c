"""Scene construction: wall runs -> structure-of-arrays plane soup.

A frozen copy of the port's ``scene/builder.py`` for the benchmark's plain
reference (NumPy only; the NumPy world RNG alone).

Reimplements the reference scene builder (`main.rs:443-588`), which converts
maze wall runs into `Plane` quads with parallel `materials`/`emissions`
arrays. Where the reference builds three Vec<.>s of #[repr(C)] structs for
Metal buffers, we build a structure-of-arrays pytree of device arrays — the
natural TPU layout (each component is a contiguous [N]-vector the VPU can
stream) — plus precomputed intersection constants so the hot kernel never
recomputes per-plane normals.

World conventions copied from the reference: +y points DOWN (floor at
y = +2, ceiling at y = -8), one maze cell = 10 world units, world centered
on the origin spanning [-half, half] where half = cell_size*height/2 — the
reference uses `height` for both axes (`main.rs:452-455`), replicated.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .maze import generate_maze, merge_horizontal_walls, merge_vertical_walls


@dataclasses.dataclass
class Scene:
    """Plane-soup scene, structure-of-arrays. All shapes [N, ...], float32.

    Mirrors the reference's parallel arrays (`main.rs:443-445`):
    mirrors: Vec<Plane{origin,v,u,color}>, materials: Vec<bool>,
    emissions: Vec<Float4> (rgb + strength in .w).
    """

    origin: np.ndarray    # [N, 3] quad corner
    v: np.ndarray         # [N, 3] first edge vector
    u: np.ndarray         # [N, 3] second edge vector
    color: np.ndarray     # [N, 3] albedo
    is_mirror: np.ndarray  # [N] bool (False = diffuse; `main.rs:444`)
    emission: np.ndarray  # [N, 4] rgb + strength
    grid: np.ndarray      # [H, W] uint8 maze bitmask (for tests/minimap)
    # Closed-world test class (render/pallas_tracer.py specialization):
    # 0 = partial quad, full 2-edge in-rectangle test (light panels);
    # 1 = full floor-to-ceiling wall, only the along-wall (v/s1) edge test
    #     is needed — any in-world ray crossing the plane beyond the
    #     vertical extent crosses floor/ceiling first at smaller t;
    # 2 = world-closing plane (floor/ceiling/outer boundary), no edge
    #     test — an in-world ray's nearest crossing is always inside.
    # 3 = TRIANGLE: the primitive is the half-parallelogram
    #     {origin + a*u + b*v : a, b >= 0, a + b <= 1} — (u, v) are the
    #     two edges from the shared corner, and the dual-basis
    #     projections s1/s2 (SceneDerived) are exactly its barycentric
    #     coordinates, so acceptance is s1 >= 0, s2 >= 0, s1 + s2 <= 1.
    #     Beyond the reference (whose only primitive is the quad,
    #     `shaders.metal:51-67`): triangles make arbitrary meshes
    #     first-class on every backend (scene/mesh.py builds them from
    #     vertex/face arrays and OBJ files).
    # Defaults to all-zero (full tests everywhere): always correct, just
    # unspecialized — so hand-built test scenes need not set it.
    kind: np.ndarray | None = None  # [N] uint8
    # Sphere primitives (custom scenes only; generated mazes have none).
    # The reference carries a sphere intersector as dead code
    # (`shaders.metal:69-85` — never dispatched, and buggy: its
    # half-chord is sqrt(r^2 + p^2) where the circle geometry needs
    # sqrt(r^2 - p^2)); here spheres are first-class on every backend.
    # One-sided from OUTSIDE: only the near root t = -b - sqrt(disc) is
    # accepted (> t_min), so rays starting inside a sphere pass through
    # — the same convention as the reference's near-root-only dead code.
    sph_center: np.ndarray | None = None    # [S, 3] float32
    sph_radius: np.ndarray | None = None    # [S] float32, > 0
    sph_color: np.ndarray | None = None     # [S, 3] albedo
    sph_is_mirror: np.ndarray | None = None  # [S] bool
    sph_emission: np.ndarray | None = None  # [S, 4] rgb + strength
    # Dielectric materials (beyond the reference, whose only materials
    # are diffuse and mirror, `main.rs:444`): a primitive with ior > 0
    # is GLASS with that index of refraction — it neither emits nor
    # diffuses; each interaction either reflects or refracts (Snell +
    # optional Schlick Fresnel, TracerConfig.fresnel), tints throughput
    # by albedo, and counts against the mirror (specular) budget.
    # is_mirror/emission are ignored on glass primitives. Glass SPHERES
    # additionally accept the far quadratic root from inside (a closed
    # glass surface must be exit-able), while opaque spheres keep the
    # reference's near-root-only pass-through convention. ior == 0
    # (default) is the opaque material model, bit-identical to before.
    ior: np.ndarray | None = None       # [N] float32, 0 = opaque
    sph_ior: np.ndarray | None = None   # [S] float32, 0 = opaque
    # Procedural surface textures (beyond the reference, whose albedo
    # is one flat color per quad, `main.rs:443-445`): tex_kind 0 = none,
    # 1 = UV CHECKER (parity of floor(s1*scale) + floor(s2*scale) in
    # the primitive's own edge coordinates — planes/triangles only),
    # 2 = WORLD checker (parity of sum(floor(hit_xyz / scale)) — any
    # primitive, including spheres). Odd-parity cells use tex_color2 in
    # place of color; the textured albedo feeds diffuse attenuation,
    # the mirror tint, and the glass tint alike. tex_scale is cells per
    # edge (kind 1) or the world-units cell size (kind 2); must be > 0
    # wherever tex_kind > 0.
    tex_kind: np.ndarray | None = None      # [N] uint8 (0 / 1 / 2)
    tex_scale: np.ndarray | None = None     # [N] float32
    tex_color2: np.ndarray | None = None    # [N, 3] float32
    sph_tex_kind: np.ndarray | None = None  # [S] uint8 (0 / 2)
    sph_tex_scale: np.ndarray | None = None   # [S] float32
    sph_tex_color2: np.ndarray | None = None  # [S, 3] float32

    def __post_init__(self):
        if self.kind is None:
            self.kind = np.zeros(self.origin.shape[0], dtype=np.uint8)
        if self.sph_center is None:
            self.sph_center = np.zeros((0, 3), dtype=np.float32)
        s = self.sph_center.shape[0]
        if self.sph_radius is None:
            self.sph_radius = np.ones(s, dtype=np.float32)
        if self.sph_color is None:
            self.sph_color = np.full((s, 3), 0.5, dtype=np.float32)
        if self.sph_is_mirror is None:
            self.sph_is_mirror = np.zeros(s, dtype=bool)
        if self.sph_emission is None:
            self.sph_emission = np.zeros((s, 4), dtype=np.float32)
        if self.ior is None:
            self.ior = np.zeros(self.origin.shape[0], dtype=np.float32)
        if self.sph_ior is None:
            self.sph_ior = np.zeros(s, dtype=np.float32)
        for f in ("ior", "sph_ior"):
            if np.any(np.asarray(getattr(self, f)) < 0):
                raise ValueError(f"{f} must be >= 0 (0 = opaque)")
        n = self.origin.shape[0]
        if self.tex_kind is None:
            self.tex_kind = np.zeros(n, dtype=np.uint8)
        if self.tex_scale is None:
            self.tex_scale = np.ones(n, dtype=np.float32)
        if self.tex_color2 is None:
            self.tex_color2 = np.zeros((n, 3), dtype=np.float32)
        if self.sph_tex_kind is None:
            self.sph_tex_kind = np.zeros(s, dtype=np.uint8)
        if self.sph_tex_scale is None:
            self.sph_tex_scale = np.ones(s, dtype=np.float32)
        if self.sph_tex_color2 is None:
            self.sph_tex_color2 = np.zeros((s, 3), dtype=np.float32)
        for f, hi in (("tex_kind", 2), ("sph_tex_kind", 2)):
            k = np.asarray(getattr(self, f))
            if np.any(k > hi):
                raise ValueError(f"{f} must be in 0..{hi}")
        if np.any(np.asarray(self.sph_tex_kind) == 1):
            raise ValueError(
                "sph_tex_kind 1 (UV checker) is undefined for spheres — "
                "use kind 2 (world checker)"
            )
        for kf, sf in (("tex_kind", "tex_scale"),
                       ("sph_tex_kind", "sph_tex_scale")):
            k = np.asarray(getattr(self, kf))
            sc = np.asarray(getattr(self, sf))
            if np.any((k > 0) & ~(sc > 0)):
                raise ValueError(f"{sf} must be > 0 wherever {kf} > 0")
        for f in ("ior", "tex_kind", "tex_scale", "tex_color2"):
            if getattr(self, f).shape[0] != n:
                raise ValueError(
                    f"{f} has {getattr(self, f).shape[0]} rows but "
                    f"origin has {n}"
                )
        if s and not np.all(np.asarray(self.sph_radius) > 0):
            raise ValueError("sphere radii must be positive")
        # Leading-dim consistency: catches dataclasses.replace() that
        # sets sph_center but inherits another sphere count's arrays.
        # LOAD-BEARING fields (radius/color/is_mirror/emission — a
        # silent default would invent visible geometry) raise on ANY
        # mismatch. NEUTRAL-DEFAULT fields (ior 0 = opaque, tex_kind
        # 0 = untextured) are re-defaulted when either side is length
        # zero — the unambiguous replace()-across-sphere-count case —
        # so growing/shrinking a sphere set does not require restating
        # fields whose default changes nothing about the image.
        for f in ("sph_radius", "sph_color", "sph_is_mirror",
                  "sph_emission"):
            if getattr(self, f).shape[0] != s:
                raise ValueError(
                    f"{f} has {getattr(self, f).shape[0]} rows but "
                    f"sph_center has {s} — pass all sphere fields "
                    "together (replace() keeps old arrays, it does not "
                    "re-default them)"
                )
        neutral = dict(
            sph_ior=lambda: np.zeros(s, np.float32),
            sph_tex_kind=lambda: np.zeros(s, np.uint8),
            sph_tex_scale=lambda: np.ones(s, np.float32),
            sph_tex_color2=lambda: np.zeros((s, 3), np.float32),
        )
        for f, make in neutral.items():
            rows = getattr(self, f).shape[0]
            if rows != s and (rows == 0 or s == 0):
                setattr(self, f, make())
            elif rows != s:
                raise ValueError(
                    f"{f} has {rows} rows but sph_center has {s}"
                )

    @property
    def num_planes(self) -> int:
        return self.origin.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    def derived(self) -> "SceneDerived":
        return SceneDerived.from_scene(self)


@dataclasses.dataclass
class SceneDerived:
    """Precomputed per-plane intersection constants.

    The reference kernel recomputes normalize(cross(v, u)) and the edge
    PROJECTIONS per ray-plane test (`shaders.metal:51-67`):
    0 <= dot(X-origin, v)/|v| <= |v|. That projection test is exact only
    for ORTHOGONAL edge pairs — every quad the reference ever builds —
    and for skewed parallelograms accepts a sheared region that extends
    OUTSIDE the quad's corner AABB, silently diverging from any
    AABB-based culling (the BVH traversal, the pallas per-tile skip).
    We instead hoist the exact DUAL BASIS of (u, v): with
    w1 = (u x n) / dot(u x n, v) and w2 = (v x n) / dot(v x n, u) the
    in-parallelogram test is 0 <= dot(X, wi) - bi <= 1 — the same pure
    FMAs over precomputed constants, but the accepted region is the true
    parallelogram {origin + a*u + b*v : a, b in [0, 1]} for ANY edge
    pair. For orthogonal quads the duals reduce algebraically to the
    reference's v/|v|^2, u/|u|^2 (u x n is parallel to v when u.v = 0),
    so generated-maze output is unchanged. Duals are computed in float64
    and rounded once.

    Degenerate planes (zero-extent wall runs, see scene/maze.py) get
    valid=False and normal/w rows of zeros, keeping NaNs out of the arrays.
    """

    normal: np.ndarray   # [N, 3] unit normal (= normalize(cross(v, u)))
    d: np.ndarray        # [N] plane offset: dot(origin, normal)
    w1: np.ndarray       # [N, 3] dual of v: (u x n) / dot(u x n, v)
    b1: np.ndarray       # [N] dot(origin, w1)
    w2: np.ndarray       # [N, 3] dual of u: (v x n) / dot(v x n, u)
    b2: np.ndarray       # [N] dot(origin, w2)
    color: np.ndarray    # [N, 3]
    is_mirror: np.ndarray  # [N] bool
    emission: np.ndarray   # [N, 4]
    valid: np.ndarray    # [N] bool

    @staticmethod
    def from_scene(s: Scene) -> "SceneDerived":
        v64 = np.asarray(s.v, np.float64)
        u64 = np.asarray(s.u, np.float64)
        n = np.cross(v64, u64)
        n_len = np.linalg.norm(n, axis=-1)
        v2 = np.sum(v64 * v64, axis=-1)
        u2 = np.sum(u64 * u64, axis=-1)
        valid = (n_len > 0) & (v2 > 0) & (u2 > 0)
        safe = np.where(valid, n_len, 1.0)
        normal = n / safe[:, None]
        normal = np.where(valid[:, None], normal, 0.0)
        # Dual-basis denominators: dot(u x n, v) = |u x v|^2 / |n_raw|
        # (> 0) and dot(v x n, u) = -|u x v|^2 / |n_raw| — both nonzero
        # exactly when the quad is non-degenerate, so `valid` already
        # guards them.
        uxn = np.cross(u64, n)
        vxn = np.cross(v64, n)
        d1 = np.sum(uxn * v64, axis=-1)
        d2 = np.sum(vxn * u64, axis=-1)
        w1 = uxn / np.where(valid, d1, 1.0)[:, None]
        w2 = vxn / np.where(valid, d2, 1.0)[:, None]
        # Round the duals to their stored f32 BEFORE deriving b, so the
        # kernels' s(origin) = dot(origin, w_f32) - b is ~0 with the
        # constants they actually use.
        w1 = np.where(valid[:, None], w1, 0.0).astype(np.float32)
        w2 = np.where(valid[:, None], w2, 0.0).astype(np.float32)
        o64 = np.asarray(s.origin, np.float64)
        return SceneDerived(
            normal=normal.astype(np.float32),
            d=np.sum(o64 * normal, axis=-1).astype(np.float32),
            w1=w1,
            b1=np.sum(o64 * w1.astype(np.float64), axis=-1).astype(np.float32),
            w2=w2,
            b2=np.sum(o64 * w2.astype(np.float64), axis=-1).astype(np.float32),
            color=s.color,
            is_mirror=s.is_mirror,
            emission=s.emission,
            valid=valid,
        )


def build_scene(cfg) -> Scene:
    """Generate the maze and emit the full plane soup (`main.rs:356-588`).

    Plane order matches the reference: vertical wall runs (each optionally
    followed by its inset light), horizontal runs likewise, then the four
    outer boundary walls, the floor, one fixed light panel, and the ceiling.
    A single RNG stream drives edge shuffling then material/light rolls in
    that order, as in the reference's reuse of one StdRng (`main.rs:381,460`).

    The stream is NumPy's PCG64 seeded with ``cfg.seed`` (the port's
    ``rng="numpy"``, the configurations' setting); the port's
    reference-compatible ChaCha12 stream is not copied here.
    """
    if cfg.rng != "numpy":
        raise ValueError(f"the reference builds mazes of rng 'numpy', got {cfg.rng!r}")
    rng = np.random.default_rng(cfg.seed)

    def roll(threshold: float) -> bool:
        return rng.random() < threshold

    grid = generate_maze(cfg.width, cfg.height, rng)
    vert = merge_vertical_walls(grid)
    hori = merge_horizontal_walls(grid)

    cs = cfg.cell_size
    half = cfg.world_half_extent
    top = cfg.wall_top_y
    wall_u = np.array([0.0, -cfg.wall_height, 0.0])
    light_u = np.array([0.0, -cfg.light_height, 0.0])
    wall_color = np.array(cfg.wall_color)
    light_em = np.array([*cfg.light_emission, cfg.light_strength])
    no_em_red = np.array([1.0, 0.0, 0.0, 0.0])    # main.rs:465 (strength 0)
    no_em_white = np.array([1.0, 1.0, 1.0, 0.0])  # main.rs:524 (strength 0)

    origins: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    us: List[np.ndarray] = []
    colors: List[np.ndarray] = []
    mirrors: List[bool] = []
    emissions: List[np.ndarray] = []
    kinds: List[int] = []
    borders: List[bool] = []   # wall run lies ON the world edge

    def push(o, vv, uu, col, mirror, em, kind=0, border=False):
        origins.append(np.asarray(o, dtype=np.float64))
        vs.append(np.asarray(vv, dtype=np.float64))
        us.append(np.asarray(uu, dtype=np.float64))
        colors.append(np.asarray(col, dtype=np.float64))
        mirrors.append(bool(mirror))
        emissions.append(np.asarray(em, dtype=np.float64))
        kinds.append(int(kind))
        borders.append(bool(border))

    # Vertical wall runs (`main.rs:449-481`): a run (x, start, len) lies on
    # grid line x, spanning z in [start, start+len] cells.
    for line, start, length in vert:
        o = [-half + line * cs, top, -half + start * cs]
        push(o, [0.0, 0.0, length * cs], wall_u, wall_color,
             not roll(1.0 - cfg.vert_mirror_prob), no_em_red, kind=1,
             border=line in (0, cfg.width))
        if length <= cfg.light_max_run and roll(cfg.light_prob):
            push([o[0] + cfg.light_inset, top, o[2]],
                 [0.0, 0.0, cfg.light_length], light_u, wall_color,
                 False, light_em)

    # Horizontal wall runs (`main.rs:483-515`): run (y, start, len) lies on
    # grid line y, spanning x in [start, start+len] cells.
    for line, start, length in hori:
        o = [-half + start * cs, top, -half + line * cs]
        push(o, [length * cs, 0.0, 0.0], wall_u, wall_color,
             not roll(1.0 - cfg.hori_mirror_prob), no_em_red, kind=1,
             border=line in (0, cfg.height))
        if length <= cfg.light_max_run and roll(cfg.light_prob):
            push([o[0], top, o[2] + cfg.light_inset],
                 [cfg.light_length, 0.0, 0.0], light_u, wall_color,
                 False, light_em)

    # Four outer boundary walls (`main.rs:517-548`), inset OUTWARD by a
    # hair. The maze's border wall runs lie exactly on the world edge, so
    # without the inset a border wall and its backing boundary plane are
    # the same plane and a ray's nearest hit is an exact tie — which the
    # kernel's one-hot select resolves by SUMMING the tied planes'
    # properties (doubled normals, mirror+diffuse mashups). The boundary
    # is a pure world-closing backstop, fully hidden behind the border
    # walls, so pushing it 1e-3 behind them makes every such tie strict
    # (wall wins, matching the reference's first-found pick) with no
    # visible change.
    bh = cfg.boundary_height
    span = 2.0 * half
    eps = 1e-3
    push([-half, top, -half - eps], [0.0, -bh, 0.0], [span, 0.0, 0.0],
         wall_color, False, no_em_white, kind=2)
    push([-half, top, half + eps], [span, 0.0, 0.0], [0.0, -bh, 0.0],
         wall_color, False, no_em_white, kind=2)
    push([-half - eps, top, -half], [0.0, 0.0, span], [0.0, -bh, 0.0],
         wall_color, False, no_em_white, kind=2)
    push([half + eps, top, -half], [0.0, -bh, 0.0], [0.0, 0.0, span],
         wall_color, False, no_em_white, kind=2)

    # Floor (`main.rs:549-556`).
    push([-half, top, half], [0.0, 0.0, -span], [span, 0.0, 0.0],
         cfg.floor_color, False, no_em_white, kind=2)

    # Fixed light panel (`main.rs:559-566`): at (-5, 2, -49.9) for the
    # default 10x10/100-unit world; generalized as below.
    push([-cs / 2.0, top, -(half - cfg.light_inset)],
         [cs, 0.0, 0.0], light_u, [0.0, 0.0, 0.0], False, light_em)

    # Ceiling (`main.rs:578-585`): faint warm emission.
    push([-half, top - cfg.wall_height, half], [0.0, 0.0, -span],
         [span, 0.0, 0.0], cfg.ceiling_color, False,
         np.array([*cfg.light_emission, cfg.ceiling_emission_strength]),
         kind=2)

    mirrors_arr = np.array(mirrors, dtype=bool)
    n = mirrors_arr.shape[0]
    ior = np.zeros(n, np.float32)
    if cfg.glass_prob > 0.0:
        # Glass walls (MazeConfig.glass_prob): a random subset of the
        # MIRROR walls becomes dielectric panes. Drawn from a SEPARATE
        # seeded stream so the main rng's draw order — maze layout,
        # mirror picks, light rolls, all bit-matching the reference —
        # is untouched at any glass_prob, and glass_prob 0 (default)
        # changes nothing at all.
        # BORDER wall runs (on the world edge) stay mirror: a glass
        # pane there refracts rays OUT of the closed world (the
        # boundary backstop sits within t_min behind it), breaking the
        # closed-world invariant the kernel's kind-2 no-edge-test
        # specialization and the reference's miss-free tracing rely on.
        grng = np.random.default_rng(cfg.seed ^ 0x61A55)
        glass = (
            mirrors_arr
            & (grng.random(n) < cfg.glass_prob)
            & ~np.array(borders, dtype=bool)
        )
        ior[glass] = cfg.glass_ior
        mirrors_arr = mirrors_arr & ~glass

    color_arr = np.stack(colors).astype(np.float32)
    if cfg.glass_prob > 0.0:
        color_arr[glass] = np.asarray(cfg.glass_color, np.float32)

    return Scene(
        origin=np.stack(origins).astype(np.float32),
        v=np.stack(vs).astype(np.float32),
        u=np.stack(us).astype(np.float32),
        color=color_arr,
        is_mirror=mirrors_arr,
        emission=np.stack(emissions).astype(np.float32),
        grid=grid,
        kind=np.array(kinds, dtype=np.uint8),
        ior=ior,
    )
