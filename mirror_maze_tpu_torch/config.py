"""Configuration system for the mirror-maze engine (PyTorch/CUDA port).

A copy of the JAX package's ``config.py``: the two must stay field-for-field
equal (tests/test_torch_config.py). The comments below describe the
reference engine the fields were lifted from.

The reference hardcodes every operating constant (resolution `main.rs:599-600`,
chunk width `main.rs:602`, fps `main.rs:760`, maze dims `main.rs:362-363`,
camera spawn/look `main.rs:735,740`, move speed `main.rs:792`, mouse
sensitivity `main.rs:923`, and in-shader `bounce_limit=5`, `mirror_limit=15`,
`lighting_factor=0.25` with a `//TODO: uniform this` at `shaders.metal:293-296`).
This module lifts all of them into frozen dataclasses so every config in
BASELINE.json is expressible without code edits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MazeConfig:
    """Maze-generation parameters (reference: `main.rs:362-363`, 10x10 cells)."""

    width: int = 10            # cells in x
    height: int = 10           # cells in y (z in world space)
    cell_size: float = 10.0    # world units per cell (`main.rs:452`, 10.0)
    # World RNG backend. "numpy" (default): NumPy PCG64 — deterministic
    # by seed, but NOT the reference's stream. "reference": a
    # rand-0.8-StdRng-compatible ChaCha12 stream (utils/refrng.py), so
    # the generated world — maze topology, mirror picks, light
    # placements — is WALL-FOR-WALL the world the reference app builds
    # at the same seed (`main.rs:381-382, 460-514`).
    rng: str = "numpy"
    wall_top_y: float = 2.0    # walls span y in [top - height, top]; y points DOWN
    wall_height: float = 10.0  # maze wall height (`main.rs:457`, u=(0,-10,0))
    boundary_height: float = 20.0  # outer boundary wall height (`main.rs:519`)
    seed: int = 0              # reference: StdRng::seed_from_u64(0) (`main.rs:381`)

    # Material probabilities (`main.rs:460-464` vertical 15% mirror,
    # `main.rs:494-498` horizontal 10% mirror).
    vert_mirror_prob: float = 0.15
    hori_mirror_prob: float = 0.10
    # GLASS walls (beyond the reference's diffuse/mirror pair): each
    # MIRROR wall run becomes a dielectric pane with this probability,
    # at glass_ior. Drawn from a SEPARATE seeded stream AFTER the build
    # so 0 (the default) leaves every generated world bit-identical to
    # the reference's, and raising it never re-rolls the maze layout,
    # mirror picks, or lights.
    glass_prob: float = 0.0
    glass_ior: float = 1.5
    # Glass panes swap the wall albedo for this pale tint (the wall
    # grey would read as smoked glass — each interaction multiplies
    # throughput by the albedo).
    glass_color: Tuple[float, float, float] = (0.85, 0.9, 0.95)

    # Inset warm light panels on short walls (`main.rs:467-480, 501-514`):
    # runs of length <= light_max_run get a light_prob chance of a light panel
    # inset by light_inset, sized light_length x light_height, with
    # emission light_emission (rgb) * light_strength.
    light_max_run: float = 2.0
    light_prob: float = 0.3
    light_inset: float = 0.1
    light_length: float = 9.9
    light_height: float = 6.0

    wall_color: Tuple[float, float, float] = (0.3, 0.35, 0.4)     # main.rs:447
    floor_color: Tuple[float, float, float] = (0.4, 0.45, 0.3)    # main.rs:553
    ceiling_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)   # main.rs:582
    light_emission: Tuple[float, float, float] = (1.0, 0.8, 0.3)  # main.rs:479
    light_strength: float = 2.0                                    # main.rs:479
    ceiling_emission_strength: float = 0.02                        # main.rs:585

    def __post_init__(self):
        if self.rng not in ("numpy", "reference"):
            raise ValueError(f"rng must be 'numpy' or 'reference' (got {self.rng!r})")
        # ior <= 0 means "opaque" in Scene.ior, so glass_prob > 0 with a
        # non-physical ior would silently demote the selected mirror
        # walls to pale diffuse panes (is_mirror stripped, albedo
        # recolored) instead of producing glass. Fail loudly instead.
        if not 0.0 <= self.glass_prob <= 1.0:
            raise ValueError(f"glass_prob must be in [0, 1] (got {self.glass_prob})")
        if self.glass_prob > 0.0 and self.glass_ior <= 0.0:
            raise ValueError(
                f"glass_ior must be > 0 when glass_prob > 0 (got {self.glass_ior}); "
                "ior <= 0 marks a surface opaque"
            )

    @property
    def world_half_extent(self) -> float:
        """World spans [-half, half] in x and z (`main.rs:452`: -10*h/2 + i*10)."""
        return self.cell_size * self.height / 2.0


@dataclasses.dataclass(frozen=True)
class TracerConfig:
    """Path-tracer parameters (reference: `shaders.metal:293-296`)."""

    bounce_limit: int = 5      # max diffuse/miss segments
    mirror_limit: int = 15     # mirror segment budget; hitting it kills the ray
    lighting_factor: float = 0.25   # sky falloff base (`shaders.metal:337`)
    sky_color: Tuple[float, float, float] = (0.3, 0.6, 0.8)
    sky_strength: float = 0.0  # reference multiplies the sky term by 0.0
    mirror_tint: float = 0.005  # additive mirror tint (`shaders.metal:327`)
    t_min: float = 0.1         # min hit distance (`shaders.metal:63`, a > 0.1)
    jitter: float = 0.001      # AA ray-direction jitter (`shaders.metal:303`)
    # Mix the per-pixel noise-texture sample into the RNG seed, as the
    # reference does (`shaders.metal:288-300`, `main.rs:667-695`). Off by
    # default: the counter-based seeding is already decorrelated; on, the
    # reference's spatially-correlated grain is reproduced (pallas path).
    noise_rng: bool = False
    # Dielectric (glass) reflect/refract split. True (default): Schlick
    # Fresnel probability decides per interaction (physically plausible;
    # consumes one extra RNG draw per segment on glass-bearing scenes).
    # False: refract unless total internal reflection — fully
    # DETERMINISTIC, the seam the cross-backend exactness tests use.
    # Scenes without dielectrics (Scene.ior all zero) trace identically
    # under either value (the glass stage is statically absent).
    fresnel: bool = True
    # Rays per pallas program in units of 128 lanes (B = block_rows*128).
    # Measured on v5e with the wide (8, B/8) ray-state layout (PERF.md):
    # on Morton-sorted chunk windows wider is better — 128 wins single-
    # tile scenes (156.6 vs 153.4 Mrays/s at 32) and 16 wins multi-tile
    # scenes (where blocks must stay screen-coherent for the tile skip).
    # The perf presets (config_interactive/config_scale) set those; this
    # default stays 32 for golden/test stability. Block size changes the
    # per-block RNG stream grouping, so it is image-affecting.
    block_rows: int = 32
    # Lanes per dense_nearest sub-block (the dot/test/select stage runs
    # chunked at this width). Bitwise-identical to the monolithic form
    # at any value (each output column depends only on its own lanes) —
    # purely a scheduling knob. None (default) = monolithic, which
    # MEASURED FASTEST at every tried width (PERF.md "lane-chunk
    # sweep"); kept for experiments on other scene geometries.
    lane_chunk: int | None = None
    # Compensated hit-test dot (round 5). The MXU truncates f32 matmul
    # inputs to bf16 (single pass, measured bitwise), giving edge-test
    # coordinates an ABSOLUTE error ~2^-9 * |o| — catastrophic for
    # small rectangles far from the origin (the 64x64 scale world spans
    # +-320 units: light panels lost ~93% of scene luminance on
    # silicon, round-5 finding). The fix splits BOTH operands into a
    # bf16-exact hi + f32 residual and computes Wh.Gh + Wh.Gl + Wl.Gh
    # as ONE [rows, 24] x [24, B] matmul — K grows 8 -> 24, and MXU
    # pass count is K-independent below K = 128, so the fix is FREE in
    # passes (PERF.md "MXU-pass floor"). None (default): on for
    # hardware, off under the exact CPU interpreter (whose f32 dot is
    # already exact — goldens unchanged, same policy as _rcp).
    # True/False force it (tests; cross-checking).
    compensated_dot: bool | None = None
    # Precomputed slab-test schedule for multi-tile scenes: every
    # tile's tmin-independent tn/tf chain is unrolled up front into
    # VMEM scratch (independent chains pipeline) instead of re-running
    # as pure latency inside the serial tile loop — the config-5
    # anatomy's per-segment fixed cost (PERF.md). Bit-identical skip
    # decisions (same math, same near-to-far order; only the schedule
    # moves); single-tile scenes are untouched. Default off pending
    # the measured verdict.
    slab_precompute: bool = False

    def __post_init__(self):
        # A negative falloff base has no well-defined real power for
        # fractional exponents and would NaN the sky term in both tracers.
        if self.sky_strength != 0.0 and self.lighting_factor < 0.0:
            raise ValueError(
                f"lighting_factor must be >= 0 when sky_strength != 0 "
                f"(got {self.lighting_factor})"
            )

    @property
    def max_segments(self) -> int:
        """Static trip count for the fixed-shape bounce loop.

        The reference loop (`shaders.metal:306`) runs while
        ``n < bounce_limit + mirror_hits``; since mirror_hits <= mirror_limit
        and the iteration that reaches the mirror limit terminates, the loop
        body executes at most bounce_limit + mirror_limit times.
        """
        return self.bounce_limit + self.mirror_limit


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera & movement (reference: `main.rs:732-764, 786-815, 922-925`)."""

    spawn: Tuple[float, float, float] = (-5.0, 0.0, -45.0)  # main.rs:735
    look_dir: Tuple[float, float, float] = (0.1, 0.0, 1.0)  # main.rs:740
    focal_length: float = 1.0                                # main.rs:736
    viewport_height: float = 2.0                             # main.rs:732
    move_speed: float = 5.0          # units per second (`main.rs:792`, 5/fps)
    mouse_sensitivity: float = 1.0 / 512.0                   # main.rs:923
    player_half_extent: Tuple[float, float, float] = (0.5, 0.2, 0.5)  # main.rs:738
    # Thin-lens depth of field (beyond the reference's pinhole camera):
    # aperture > 0 jitters each SAMPLE's origin on a lens disk of that
    # radius and re-aims it at the ray's focal point at ``focus_dist``
    # along the ray, so geometry off the focal distance blurs (bokeh).
    # 0 (default) is the reference's pinhole — statically absent, so
    # existing images are bit-unchanged.
    aperture: float = 0.0
    focus_dist: float = 10.0

    def __post_init__(self):
        if self.aperture < 0.0:
            raise ValueError(f"aperture must be >= 0, got {self.aperture}")
        if self.aperture > 0.0 and not self.focus_dist > 0.0:
            # focus_dist 0 would aim every sample back through the lens
            # ring (focal point == camera center) — garbage frames.
            raise ValueError(
                f"focus_dist must be > 0 when aperture > 0, got "
                f"{self.focus_dist}"
            )


@dataclasses.dataclass(frozen=True)
class ScreenConfig:
    """Resolution, progressive-refresh and display (`main.rs:599-603, 646-650`)."""

    width: int = 1024
    height: int = 768
    chunk_width: int = 4       # pixel chunk side (`main.rs:602`)
    # Chunks refreshed per frame. The reference dispatches
    # (W/2/ppc) x (H/2/ppc) threadgroups = 32x24 = 768 chunks at 1024x768
    # (`main.rs:646-650`), i.e. 1/64 of the 49,152 total chunks.
    # None = derive the same 1/64 fraction from the resolution.
    chunks_per_frame: int | None = None
    samples_per_pixel: int = 64  # 1024 threads / 16 px per chunk (`main.rs:641-644`)
    fps: float = 60.0
    # The reference screen texture is RGBA8Unorm (`main.rs:704`): every write
    # clamps to [0,1] and quantizes to 8 bits, which stabilizes the feedback
    # blur. Set False for float32 accumulation.
    quantize_8bit: bool = True
    # Feedback blur (fragment_shader, `shaders.metal:214-225`): out =
    # (c + (l+r)/2 + (u+d)/2) / 3, written back into the screen texture.
    feedback_blur: bool = True
    # Morton-sort each frame's popped chunk window so tracer blocks see
    # spatially coherent rays (scheduler.sort_window_morton). Which
    # chunks refresh is unchanged; only ray layout (and hence each
    # pixel's RNG lane) differs. Essential for multi-tile scenes with
    # wide blocks; off by default to keep small-scene goldens stable.
    sort_chunk_window: bool = False
    # ADAPTIVE epoch order (beyond the reference): when the chunk queue
    # wraps into a new epoch, reorder it by descending per-chunk
    # luminance variance of the accumulated screen so detailed/grainy
    # regions refresh first (render/scheduler.py adaptive_reorder).
    # Coverage is unchanged (still a permutation; full repaint per
    # epoch; rotation keeps the reference's random reshuffle) — only
    # the within-epoch ORDER adapts. Off by default: the reference
    # replays one fixed shuffled order per epoch.
    adaptive_refresh: bool = False
    # Fused Pallas blur+quantize present kernel (render/present.py) —
    # bit-identical to the XLA chunk-major blur under jit, one
    # read+write of the screen instead of XLA's materialized shifted
    # slices (0.083 vs 0.752 ms at 1080p, PERF.md). The sharded engine
    # uses it too, with the ppermute'd band halos embedded as kernel
    # inputs (parallel/shard.py _present_with_halo).
    pallas_present: bool = True

    def __post_init__(self):
        # The chunk grid must tile the screen exactly: a 30-px-wide
        # screen at chunk_width 4 would floor to 7 chunk columns and the
        # rightmost 2 pixel columns would silently NEVER refresh (and
        # the chunk-major <-> spatial reshapes would disagree with
        # width/height).
        if self.width % self.chunk_width or self.height % self.chunk_width:
            raise ValueError(
                f"width/height ({self.width}x{self.height}) must be "
                f"multiples of chunk_width={self.chunk_width}: the "
                "progressive-refresh chunk grid must tile the screen "
                "exactly"
            )
        # The scheduler pops each frame's window from a DOUBLED permutation
        # slice (render/scheduler.py take_chunks); the scatter then declares
        # unique indices (render/accumulate.py). Both are only valid while
        # one window never repeats a chunk, i.e. window size <= total
        # chunks — enforce the precondition instead of assuming it.
        # The fused Pallas present kernel shifts +-3*chunk_width lanes
        # and reads at most one 128-lane halo block across strip
        # borders (render/present.py); wider chunks must use the XLA
        # present path. Caught here so the error names the knob instead
        # of surfacing as an out-of-bounds slice at kernel trace time.
        if self.pallas_present and self.feedback_blur and (
            3 * self.chunk_width > 128
        ):
            raise ValueError(
                f"chunk_width={self.chunk_width} exceeds the fused "
                "present kernel's halo (needs 3*chunk_width <= 128, "
                "i.e. chunk_width <= 42); set pallas_present=False to "
                "use the XLA blur+quantize path at this chunk size"
            )
        if (
            self.chunks_per_frame is not None
            and self.chunks_per_frame > self.total_chunks
        ):
            raise ValueError(
                f"chunks_per_frame={self.chunks_per_frame} exceeds "
                f"total_chunks={self.total_chunks} "
                f"({self.chunks_x}x{self.chunks_y} grid): one frame window "
                "would repeat chunks, breaking the scheduler's "
                "unique-window invariant"
            )

    @property
    def pixels_per_chunk(self) -> int:
        return self.chunk_width * self.chunk_width

    @property
    def chunks_x(self) -> int:
        return self.width // self.chunk_width

    @property
    def chunks_y(self) -> int:
        return self.height // self.chunk_width

    @property
    def total_chunks(self) -> int:
        return self.chunks_x * self.chunks_y

    @property
    def effective_chunks_per_frame(self) -> int:
        if self.chunks_per_frame is not None:
            return self.chunks_per_frame
        # Reference ratio: (W/2/ppc) * (H/2/ppc) threadgroups per frame.
        ppc = self.pixels_per_chunk
        return max(1, (self.width // (2 * ppc)) * (self.height // (2 * ppc)))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine configuration bundling all subsystems."""

    maze: MazeConfig = MazeConfig()
    tracer: TracerConfig = TracerConfig()
    camera: CameraConfig = CameraConfig()
    screen: ScreenConfig = ScreenConfig()
    # Intersection backend: "brute" (vectorized all-planes MXU test),
    # "bvh" (masked stack traversal — reference parity semantics),
    # "exact" (dense all-planes test in full-f32 VPU FMAs: the
    # traversal's hardware-exactness class at dense-path speed,
    # render/intersect.py nearest_hit_exact), "pallas" (fused wavefront
    # kernel — the fast path).
    intersector: str = "pallas"

    def __post_init__(self):
        if self.intersector not in ("brute", "bvh", "exact", "pallas"):
            raise ValueError(
                f"intersector must be brute|bvh|exact|pallas "
                f"(got {self.intersector!r})"
            )

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


# --- Named configurations matching BASELINE.json "configs" -------------------

def config_v0() -> EngineConfig:
    """Config 1: 4x4 maze, 256x256, 1 spp, 1 bounce, brute-force, no BVH."""
    return EngineConfig(
        maze=MazeConfig(width=4, height=4),
        tracer=TracerConfig(bounce_limit=1, mirror_limit=1),
        camera=CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=ScreenConfig(width=256, height=256, samples_per_pixel=1,
                            chunks_per_frame=None),
        intersector="brute",
    )


def config_bvh() -> EngineConfig:
    """Config 2: 8x8 maze, 4 mirror bounces, full materials — the scene
    whose BVH machinery (build + host collision) SURVEY.md's build order
    introduces.

    The DEFAULT intersector here is pallas: the reference's per-ray
    stack traversal (`render/intersect.py nearest_hit_bvh`, rebuilt
    around packed row gathers (27x), a stack-major one-hot stack
    (2.26x), and a 2-gather/iteration layout (1.16x)) measures
    0.26 Mrays/s on TPU at this config's camera — ~165x slower than
    the dense tile path at the same point (46.6 vs 0.281 ms/frame),
    and MEASURED AT its serial-latency floor (PERF.md "bvh floor
    decomposition"): data-dependent walks are hostile to 8x128 vector
    lanes. It remains available as a reference-PARITY backend via
    ``--intersector bvh`` (exactness-tested against brute force); for
    full-f32 hardware exactness at dense-path speed use
    ``--intersector exact`` (27.7x the traversal here, bit-identical
    results to it on silicon). The BVH itself stays load-bearing for
    host collision + the scene AABB tile skip."""
    return EngineConfig(
        maze=MazeConfig(width=8, height=8),
        tracer=TracerConfig(bounce_limit=5, mirror_limit=4),
        camera=CameraConfig(spawn=(-5.0, 0.0, -35.0)),
        screen=ScreenConfig(width=512, height=384, samples_per_pixel=4),
        intersector="pallas",
    )


def config_fuzzy() -> EngineConfig:
    """Config 3: 16x16 maze, fuzzy accumulation look, 720p.

    noise_rng on: the reference seeds every sample from its 512x512
    noise texture (`shaders.metal:288-300`), which gives the grain its
    spatial correlation — part of the signature look this config is
    about."""
    return EngineConfig(
        maze=MazeConfig(width=16, height=16),
        # block_rows 32 measured best for this few-tile scene (PERF.md:
        # 32 -> 66.8 Mrays/s, 16 -> 61.9, 128 -> VMEM OOM); explicit so
        # it survives default changes.
        tracer=TracerConfig(noise_rng=True, block_rows=32),
        screen=ScreenConfig(width=1280, height=720),
        intersector="pallas",
    )


def config_interactive() -> EngineConfig:
    """Config 4: interactive 1080p, 8 mirror bounces.

    sort_chunk_window on: even on single-tile scenes, screen-coherent
    blocks reach the all-dead early exit sooner (same-region samples die
    together) — measured +2.4% at this operating point (PERF.md).
    block_rows 96: the round-5 K=24 compensated-dot optimum (185.6
    Mrays/s vs 183.4 at the previous 128; PERF.md headline)."""
    return EngineConfig(
        maze=MazeConfig(width=10, height=10),
        tracer=TracerConfig(bounce_limit=5, mirror_limit=8, block_rows=96),
        screen=ScreenConfig(width=1920, height=1080, sort_chunk_window=True),
        intersector="pallas",
    )


def config_scale() -> EngineConfig:
    """Config 5: 64x64 maze, 4K, 16 bounces, batched multi-camera on a mesh.

    At thousands of planes the per-tile AABB skip dominates, and it
    needs each tracer block's ray set spatially tight: the chunk window
    is Morton-sorted (sort_chunk_window) so consecutive chunks share a
    screen region, which keeps the wide latency-amortizing blocks
    coherent (PERF.md "large scenes"; block_rows 24 is the round-5
    K=24-dot optimum — 545.5 ms vs 562.6 at 16 and 547.9 at 32)."""
    return EngineConfig(
        maze=MazeConfig(width=64, height=64),
        tracer=TracerConfig(bounce_limit=5, mirror_limit=16, block_rows=24),
        screen=ScreenConfig(width=3840, height=2160,
                            sort_chunk_window=True),
        intersector="pallas",
    )


NAMED_CONFIGS = {
    "v0": config_v0,
    "bvh": config_bvh,
    "fuzzy": config_fuzzy,
    "interactive": config_interactive,
    "scale": config_scale,
    "reference": EngineConfig,
}
