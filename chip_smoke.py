#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-of DIR [--only PHASE]...]

Builds the hand-written kernels from ``mirror_maze_tpu_torch/csrc`` (nvcc,
sm_90a: the tracer's four libraries, with and without the texture stage and
the diagnostics, the present, the BVH walk, the threefry draws, the jnp
tracer's segment, ``shade``, and the step's glue, ``frame_setup``,
``camera_rays`` and ``resolve``), holds
each against its plain PyTorch version on the card at the shapes of every
path it drives (``[threefry]``: every draw of ops/prng.py bitwise, in every
output, on the main path's jitter draw and the jnp tracer's, erf_inv on
every 127th float32 pattern of [-1, 1] with each of its steps checked, and
erf_inv beside ``torch.special.erfinv``; ``[frame-glue]``: the three glue
kernels bitwise on every buffer they write, on [main]'s frame 1, a walk
into a wall and a free one, a turning frame, config_scale's frame 1 (a
window of 8,040 ids), [bands]' second band (row0 540), config_fuzzy's
frame 1 (the seed row), config_v0 and config_bvh through the jnp tracer,
config_scale at 7680x4320 (a window of 32,400 ids, frame_setup's tiled
route) and config_interactive at 4,096 spp (resolve's pieces route)),
checks the engine's scripted run against the committed golden frame, and
drives four configurations at full width through ``make_scan_step``:

- ``[main]``  ``config_interactive`` (10x10 maze, 1920x1080, 64 spp, 8
  mirror bounces; every plane group in one tile), 168 frames;
- ``[scale]`` ``config_scale`` (64x64 maze, 3840x2160, 64 spp, 16 mirror
  bounces; 2,692 planes in 5 + 17 + 1 tiles), 40 frames;
- ``[fuzzy]`` ``config_fuzzy`` (16x16 maze, 1280x720, 64 spp, the noise
  texture seeding every ray; 1 + 2 + 1 tiles), 40 frames;
- ``[glass]`` ``config_interactive`` with ``glass_prob`` 0.5 (five of the
  maze's mirror walls are glass panes; Fresnel on), 40 frames;

offline renders of 1024x1024 at 64 spp through ``render_full_frame``:
``[cornell-*]`` the Cornell box with a glass sphere through the thin lens
(and through the pinhole), with two opaque spheres, and with two blocks, a
checker floor and a world-checker wall (the texture stage); ``[mesh]`` the
mesh gallery (360 triangles in three tiles) and ``[mesh-glass]`` the same
with its triangles made glass; and further paths of the engine:

- ``[sky]`` ``config_interactive`` with the sky term on, 20 frames;
- ``[adaptive]`` ``config_interactive`` with ``adaptive_refresh``, idle
  until the chunk queue has wrapped once and been reordered by detail;
- ``[sphere-refresh]`` a sphere of the Cornell box moved on the device and
  re-derived by ``make_sphere_refresh``;
- ``[bands]`` / ``[bands-4k]`` the row-band engine of ``parallel/shard.py``:
  ``config_interactive`` as 2 bands and ``config_scale`` as 4, ALL BANDS ON
  THE ONE CARD (no multi-GPU number), each band presented by the present
  kernel's halo variant with its neighbours' rows;
- ``[scale-8k]`` ``config_scale`` at 7680x4320 and ``[spp4096]``
  ``config_interactive`` at 4,096 spp, an idle and a turning frame each
  (the glue kernels' tiled sort and pieces resolve in the step's graphs),
  and ``[spp4096-render]`` 64 pixels at 4,096 spp through ``render_pixels``;

Every frame of those engine paths is one replay of the step's captured CUDA
graph (runtime/graph.py; the first frame of each input kind eager), and each
path also runs its script through the eager loop (``make_scan_step_fn``, or
the band body without graphs): the state and frame must be bitwise equal,
and the line prints the eager ms/frame beside the graph's, the replays a
frame, the capture seconds, the graphs' pool bytes and the peak memory
reserved (each phase drops its runner first). ``[graph]`` then runs
``[main]``'s 168 frames through ``make_scan_step`` (captured under
``torch.cuda.set_sync_debug_mode("error")``), ``make_step`` one call a frame
and a ``make_step_fn`` loop before and after: bitwise equal, with the
device copies a frame of each graph route.

with the kernel checks ``[present-halo]`` (bands put together are bitwise
the whole screen's present), ``[tracer-tex-*]``, ``[tracer-diag-*]`` (the
per-block diagnostics, exact against the plain version) and ``[tracer-sky*]``;
``[glass-scale]`` (``config_scale`` with glass panes, 12 frames) and
``[tracer-grid]`` (the light of a 3-block persistent grid against the full
grid's, bitwise). What the tracer's design rests on is printed beside each
kernel check: its launch geometry (grid, threads, blocks a SM, registers,
shared bytes, whether the whole scene is resident in shared memory), and
from the plain version the share of lanes alive in warps of 32 consecutive
rays and the walked tiles such a warp scans; ``[sass]`` counts the
instructions a record of the resident kernel's scan loops compiles to. A
present row's time is a launch with the L2 emptied before it, queued behind
a spin so that the host's launch time is not in it; the back-to-back time
from a CUDA graph is printed beside it (``time_present.py``, which also
times another commit's kernel by the same method).

Then the jnp tracer's backends (render/intersect.py, render/tracer.py; the
bvh backend's walk is the ``bvh_walk`` kernel, csrc/bvh_walk.cu, and the
present kernel presents their frames), the offline path and checkpoints,
each phase with its seconds:

- ``[golden-brute]`` the golden configuration with ``intersector="brute"``:
  ``render_full_frame`` and the 28-frame script against
  ``tests/goldens/frame_brute.npz`` and ``script_brute.npz``;
- ``[v0]`` ``config_v0`` (4x4 maze, 256x256, 1 spp, brute), 40 frames, and
  the same script on the CPU in this process, by the golden rule; it,
  ``[bvh]`` and ``[exact]`` replay graphs and are held bitwise against the
  eager loop;
- ``[bvh-kernel]`` the walk kernel (its sphere fold included, one launch)
  against the plain walk, t and idx bitwise on every ray of eight sets:
  frame 1 of ``config_bvh``'s scene and of ``config_interactive``'s
  (2,027,520 rays), that frame's rays at segments 2-13 as trace_paths hands
  them to the walk (``bounce``), frame 1 of ``config_scale`` at all 21
  segments (8,232,960 rays each; both with the live rays of each segment),
  random rays in the mesh gallery, the Cornell box with spheres, the giant
  leaf, and rays with exact zero direction components; ms per launch, the
  plain walk's ms, the bound and its share; and the bounce set again with
  the live-id list of each segment (``bvh_walk@live``), against the plain
  walk on the live rays gathered; on every set the walk's work counters
  (render/intersect.py ``counters``: rays walked, nodes visited, threads
  started) equal to the plain walk's counts on the same rays and the grid
  (``--kernels-of`` a parent's checkout times that port's walk by the same
  method, so the counting's cost a launch is the ``bvh_walk`` rows'
  difference);
- ``[shade]`` the shade kernel (csrc/shade.cu) bitwise ``shade_segment_plain``
  at every segment (o, d, thr, light, mh, dc, alive, the live count and the
  live-id list) at full width: ``[bench-bvh]``'s frame-1 rays (13 segments,
  the planes-only instance, timed: row ``shade@interactive``), the Cornell
  box with two spheres, with a glass sphere under ``fresnel`` on and off,
  the checker box (a 64-row block of the 1024x1024, 64 spp frame each),
  ``[sky]``'s frame-1 rays with ``sky_strength`` 0.7 and ``config_fuzzy``'s
  with its seed row, all through the bvh backend; and rays at the sign's
  and clamp's edges (d.n = +0, -0, NaN);
- ``[bvh]`` / ``[exact]`` ``config_bvh``'s scene (8x8 maze, 512x384, 4 spp,
  5 + 4 bounces) with the traversal and with the dense exact test, 8 frames
  each, the timed call under the sync debug mode "error" (no host sync),
  their last frames against each other; ``[bands-bvh]`` the same scene and
  walk as 2 bands on the one card, graph against the eager band loop; the
  plain walk's host check every k iterations timed on frame 1's rays;
  ``[scale-bvh]`` ``config_scale`` (3840x2160) with the walk, two frames
  replayed from graphs, one walk launch a segment, bitwise the eager loop;
- ``[validate]`` bench.py ``--validate``'s deterministic light (16x16 maze,
  128x96, 1 spp, jitter 0, one segment) with brute, exact, bvh and the fused
  kernel, each against brute by the reference's hardware rule;
- ``[offline]`` a 4-frame orbit of ``config_bvh``'s scene through
  ``render_path`` with the fused kernel, written as PNG and GIF, the PNG
  read back;
- ``[resume]`` ``config_interactive``: 8 frames, ``save_state``,
  ``load_state`` onto the card, 8 more, bitwise 16 frames straight.

Then the drivers (``driver_phases``), the entry points a user calls, at
``config_interactive``'s full width, each phase with its seconds and the
kernel launches counted around it (one tracer and one present a frame
stepped, a warm-up frame included where the driver steps one):

- ``[cli-render]`` ``python -m mirror_maze_tpu_torch render`` in a subprocess
  with no ``--device``: its PNG bitwise the in-process ``render_full_frame``;
- ``[play]`` headless ``play`` of 64 frames through ``main()``, per frame,
  with ``--batch-frames 8`` and through ``--save-state`` / ``--load-state``,
  each bitwise ``run_scripted``'s 64 idle frames, with the wall fps;
- ``[play-tty]`` ``play`` in a subprocess on a pseudo-terminal: 'w' for 30
  frames, then 'q'; exit 0, the camera moved, the terminal's modes restored;
- ``[play-bands]`` ``play --sharded-bands 2``, bitwise the band engine;
- ``[serve]`` an ``EngineServer`` over HTTP: every endpoint, input moving
  the camera, ``/ckpt`` bitwise the engine's state; engine fps, delivered
  stream fps, ``fetch_ms``, ``encode_ms``;
- ``[multiplayer]`` two player processes over gloo on the one card, each
  stepping its script through the engine (one graph replay a frame) and
  again through the eager route: final states and frames bitwise, ms/frame
  of both, the gathered positions, player 1's avatar in player 0's view;
  then player 1 leaves and player 0's next step raises;
- ``[demo]``, ``[animate]`` (``config_bvh``'s scene), ``[multicam]`` (4
  cameras) and ``[minimap]`` (host only) through ``main()``: their files
  non-blank and of the right shape.

Then the repository's own entry points on the port (``entry_phases``), each
phase with its seconds:

- ``[bench]`` ``python -m mirror_maze_tpu_torch.bench`` in a subprocess with
  no ``--device``, at its defaults (``config_interactive``'s operating point,
  60 frames x 3 timed calls after a warm-up call): its JSON line
  (``backend`` cuda), one tracer and one present launch a frame, and its
  ``frame_checksum`` equal to the same configuration stepped through 240
  idle frames in process;
- ``[bench-validate]`` ``--validate``: exit 0 and ``ok`` under the CPU gates
  (bvh and exact bitwise brute; the fused kernel all but exact ties);
- ``[bench-bands]`` ``--sharded-bands 2 --frames 8 --launches 1``: the
  checksum of the band engine in process, halo present launches counted;
- ``[bench-bvh]`` ``--intersector bvh`` at the defaults (2,027,520 rays a
  frame): Mrays/s, ``launch_ms`` and the checksum, one walk and one shade
  launch a segment; in process 4 frames of it as graph replays (no host
  sync) and as the eager loop, bitwise, every walk after a frame's first
  segment on the live-id list;
- ``[soak]`` the kernel exactness soak (``tools/soak_kernel.py``): 40 random
  soups of 65,536 rays, the kernel bitwise its plain version under the
  default grid and one of 1 or 7 blocks, and within 1e-4 of the jnp tracer
  on >= 99% of rays;
- ``[examples]`` the Cornell box and the mesh gallery (``--intersector
  pallas --size 256 --spp 64``) in subprocesses, their PNGs bitwise the
  in-process render, and the multiplayer demo (3 players, 24 frames): every
  process exits 0, the GIF has 6 frames, each walker ends past its spawn.

Every phase prints one line; any failure exits non-zero. Every phase checks
its kernels' launch counts: a frame stepped launches one ``frame_setup``
(and, for a sorted window past 16,384 ids, its ``frame_setup_merge``
passes), one ``camera_rays`` and one ``resolve`` (a block of rows of an
offline render one ``camera_rays`` and one ``resolve``). A draw of ops/prng.py
launches the threefry kernel; the frame's keys and the jitter are drawn
inside the two glue launches, so a phase that ran on the card launched a
drawing kernel, and the engine paths and ``[graph]`` check the threefry
kernel's exact count (``step_draws``: the thin lens and the turning
frames). The last two lines
are the ``{"kernels": [...]}`` summary (one row per kernel and path, every
number measured or, for ``bound_ms``, computed in this run; the walk
kernel's rows ``bvh_walk``, ``bvh_walk@interactive``, ``bvh_walk@bounce``,
``bvh_walk@live`` and ``bvh_walk@scale``, the threefry kernel's
``threefry@jitter``, ``threefry@normal``, ``threefry@normal-live1`` and
``threefry@normal-live6`` (that draw on the live-id lists of segments 1 and
6) and ``threefry@erfinv``, the last with ``torch.special.erfinv``'s time as
``library_ms``,
``shade@interactive``, and the glue's ``frame_setup``, ``frame_setup@scale``,
``frame_setup@8k`` (its merge passes' launches as ``merge_launches``),
``camera_rays``, ``camera_rays@scale``, ``resolve``, ``resolve@scale`` and
``resolve@4096spp``)
and ``{"ok": true, "device": {...}}``. Every jnp
path on the card launches the shade kernel once a segment, and each
phase checks that count.

``python3 chip_smoke.py --kernels-of DIR`` runs only ``[bvh-kernel]``,
``[threefry]`` and, where the port has the glue kernels, ``[frame-glue]``
(their checks included), on the port in DIR: a ``git
archive`` of another commit unpacked there is timed on the same inputs by
the same method, so two commits compare within one call. It prints one
JSON line of the rows (ms, plain ms, bound; frame_setup's launch floor) and
the card's line. ``--only frame-glue`` (or ``bvh-kernel``, ``threefry``;
repeatable) runs only the phases named.

Needs a CUDA card: without one it exits 2 and prints no result. It uses
the first visible card only (the multiplayer phase's two processes share
it). Imports torch and numpy, the port and the port's JAX-free test helpers
(``tests/_torch_tools.py``) and ``time_present.py``, nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import inspect
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peak (NVIDIA data sheet; dense, at the 700 W limit);
# the memory rate is time_present.py's HBM_BYTES_PER_S.
FP32_OPS_PER_S = 67e12
# int32 issue: an SM's 4 schedulers issue at most one warp instruction (32
# lanes) a clock each (the Hopper architecture white paper), and integer
# adds issue to the FMA pipe (IMAD) as well as the ALU pipe, so at most 128
# lane operations an SM and clock: x 132 SMs x 1.98 GHz, the clock of the
# FP32 peak (132 x 128 lanes x 2 x 1.98e9 = 67e12). The 64 INT32 lanes of
# the ALU pipe alone would give half that, which the jitter draw beats.
INT32_OPS_PER_S = 4 * 32 * 132 * 1.98e9

# The TPU kernels these replace (file:line of the function that reaches
# pl.pallas_call in the JAX package).
# The walk kernel replaces no pl.pallas_call: the JAX package's BVH walk is
# a jax.lax.while_loop over every ray.
REPLACES = {
    "tracer": "mirror_maze_tpu/render/pallas_tracer.py:639",
    "present": "mirror_maze_tpu/render/present.py:44",
    "bvh_walk": "mirror_maze_tpu/render/intersect.py:362 (jax.lax.while_loop of "
                "nearest_hit_bvh; no pallas_call)",
    # The threefry kernel's rows: jax.random's draws, which XLA fuses under
    # jit; no pallas_call.
    "threefry@jitter": "mirror_maze_tpu/ops/sampling.py:34 (jax.random.uniform of "
                       "ray_jitter under jit; no pallas_call)",
    "threefry@normal": "mirror_maze_tpu/ops/sampling.py:25 (jax.random.normal of "
                       "unit_sphere under jit; no pallas_call)",
    "threefry@erfinv": "mirror_maze_tpu/ops/sampling.py:25 (jax.lax.erf_inv inside "
                       "jax.random.normal under jit; no pallas_call)",
    "threefry@normal-live1": "mirror_maze_tpu/ops/sampling.py:25 (jax.random.normal of "
                             "unit_sphere under jit, every ray; no pallas_call)",
    "threefry@normal-live6": "mirror_maze_tpu/ops/sampling.py:25 (jax.random.normal of "
                             "unit_sphere under jit, every ray; no pallas_call)",
    # The shade kernel: the segment body of the jnp tracer's bounce loop,
    # which XLA fuses under jit; no pallas_call.
    "shade": "mirror_maze_tpu/render/tracer.py:115 (body of trace_paths' "
             "jax.lax.fori_loop; no pallas_call)",
    # The step's glue around the two pallas_calls, which XLA fuses under jit.
    "frame_setup": "mirror_maze_tpu/runtime/step.py:159-182 (take_chunks, sort_window_morton, "
                   "integrate_movement, resolve_collision and the key chain of the jitted "
                   "step; no pallas_call)",
    "camera_rays": "mirror_maze_tpu/render/pipeline.py:70-75 (ray_directions, ray_jitter and "
                   "the ori broadcast under jit; no pallas_call)",
    "resolve": "mirror_maze_tpu/render/pipeline.py:128-129 + runtime/step.py:188 (tone_map, "
               "jnp.mean and scatter_chunk_rows under jit; no pallas_call)",
}
SOURCES = {
    "tracer": "mirror_maze_tpu_torch/csrc/tracer.cu",
    "present": "mirror_maze_tpu_torch/csrc/present.cu",
    "bvh_walk": "mirror_maze_tpu_torch/csrc/bvh_walk.cu",
    "threefry": "mirror_maze_tpu_torch/csrc/threefry.cu",
    "shade": "mirror_maze_tpu_torch/csrc/shade.cu",
    "frame_setup": "mirror_maze_tpu_torch/csrc/frame_setup.cu",
    "camera_rays": "mirror_maze_tpu_torch/csrc/camera_rays.cu",
    "resolve": "mirror_maze_tpu_torch/csrc/resolve.cu",
}

# The driven paths' scripts: idle, walking, turning, idle frames.
SCRIPTS = {"main": (64, 30, 10, 64), "scale": (16, 12, 4, 8), "fuzzy": (16, 12, 4, 8),
           "glass": (16, 12, 4, 8), "sky": (8, 6, 2, 4), "bands-4k": (4, 4, 2, 2)}
# The offline renders: a square frame, and the block of pixel rows (through
# the middle of the picture) whose rays the kernel is compared on.
GALLERY_SIZE, GALLERY_SPP, GALLERY_ROWS, GALLERY_BATCH = 1024, 64, 64, 8
# Programs of that block's 1,024 (B = 4,096 rays) the plain version traces.
GALLERY_PLAIN_PROGRAMS = 256
# Programs (blocks of B rays) of config_scale's wavefront that the plain
# version traces for the comparison, spread evenly over the wavefront.
SCALE_PLAIN_PROGRAMS = 86
# The kernels whose scan loops the build's SASS is read for: the resident,
# quads-only one-tile instantiation (RESIDENT, no WALK, SKY, PRIMS, GLASS,
# TEX or DIAG) on the general route, and the same on the axis route (AXIS).
SASS_KERNEL = "_Z12trace_kernelILb1ELb0ELb0ELb0ELb0ELb0ELb0ELb0EEv6Params"
SASS_AXIS_KERNEL = "_Z12trace_kernelILb1ELb0ELb0ELb0ELb0ELb0ELb0ELb1EEv6Params"
# The tracer rows' ms/launch on an NVIDIA H100 80GB HBM3 at 700 W before the
# kernel was redesigned for Hopper (one thread a ray, a block per 128 rays):
# printed beside this run's as a reference, never in the kernels line.
PREV_MS = {
    "tracer": 1.457926368713379, "tracer@scale": 80.60468139648438,
    "tracer@fuzzy": 2.326969528198242, "tracer@glass": 1.8829120635986327,
    "tracer@glass-scale": 89.6407, "tracer@cornell-glass": 1.7636480331420898,
    "tracer@cornell-spheres": 0.9073151588439942, "tracer@mesh": 19.911231994628906,
    "tracer@sky": 1.4658880233764648, "tracer@glass-tri": 40.39117431640625,
    "tracer@tex": 1.7170623779296874, "tracer@diag": 2.0404224395751953,
}
# The small grid the light is compared under (against the full one).
GRID_FEW = 3
# Operations of the texture stage per hit on a textured primitive: the hit
# point (6), the two edge coordinates (12), the UV count (5), the world count
# with its three divisions (8), the parity (5) and the selects (4).
TEXTURE_OPS = 40


def log(msg: str) -> None:
    print(msg, flush=True)


# The jnp-tracer paths' scripts: idle, walking, turning, idle frames.
JNP_SCRIPTS = {"v0": (12, 12, 4, 12), "bvh": (2, 2, 2, 2), "resume": (4, 4, 2, 6)}
# The BVH walk's host checks compared on [bvh]'s frame-1 rays.
CHECK_INTERVALS = (1, 2, 4, 8, 16, 32)
WALK_REPEATS = 3


def timed(fn):
    """(result, device ms) of fn, ended by a synchronize."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def others(counts: dict) -> dict:
    """A phase's launch counts but the threefry kernel's (``threefry``,
    ``threefry_uniform``, ``threefry_normal``, ``threefry_normal_listed``):
    every draw of ops/prng.py launches it, and the phases that can predict
    those counts check them apart."""
    return {k: v for k, v in counts.items() if not k.startswith("threefry")}


# The kernels that draw jax.random's numbers: the threefry kernel, and since
# the glue kernels the frame's keys (frame_setup) and the jitter
# (camera_rays), each hashed inside its own launch.
DRAWING = ("threefry", "frame_setup", "camera_rays")


def holds(counts, want: dict, draws: bool) -> bool:
    """``counts`` (a phase's launches) are ``want`` for every kernel but the
    threefry kernel, and a kernel that draws (``DRAWING``) was launched if
    and only if ``draws`` (the phase ran on the card)."""
    if counts is None:
        return False
    drew = any(v > 0 for k, v in counts.items() if k.startswith(DRAWING))
    return others(counts) == want and drew == draws


def glue(frames: int = 0, renders: int = 0) -> dict:
    """The glue kernels' launches (runtime/step.py frame_setup,
    render/frame_glue.py camera_rays and resolve): one of each a frame
    stepped (a band's frame counts as one), and one camera_rays and one
    resolve a render_pixels call (a block of rows of render_full_frame, a
    tile of the sharded renderer); the kernels with no launch left out."""
    counts = {"frame_setup": frames, "camera_rays": frames + renders,
              "resolve": frames + renders}
    return {k: v for k, v in counts.items() if v}


def step_draws(cfg, inputs) -> dict:
    """The threefry launches of the single engine's fused-tracer step over
    ``inputs`` (runtime/step.py, render/pipeline.py): the frame's keys and
    seed are drawn inside the frame_setup launch and the jitter inside the
    camera_rays launch, so only the thin lens (a fold_in and a uniform a
    frame) and a rotating frame (the permutation's split and bit draw a
    round) launch it."""
    from mirror_maze_tpu_torch.ops.prng import permutation_rounds

    n, lens = len(inputs), cfg.camera.aperture > 0.0
    turns = sum(bool(inp.rot_updated) for inp in inputs)
    return {"threefry": lens * n + 2 * permutation_rounds(cfg.screen.total_chunks) * turns,
            "threefry_uniform": lens * n}


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def states_bitwise(a, b) -> bool:
    """Two engine states (single or band), every tensor bitwise equal."""
    import torch

    flat = lambda s: [t for f in s for t in (f if isinstance(f, tuple) else (f,))]
    return all(x.dtype == y.dtype and torch.equal(x.reshape(-1).view(torch.uint8),
                                                         y.reshape(-1).view(torch.uint8))
               for x, y in zip(flat(a), flat(b)))


def no_sync(fn):
    """fn() under the sync debug mode "error": a host sync in it raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def only_graphs(runner):
    """The StepGraphs of a runner that has run on one card."""
    (graphs,) = runner.graphs.values()
    return graphs


def graph_line(graphs) -> str:
    """A runner's graphs: kinds, capture seconds, pool bytes, and the
    peak device memory reserved since the phase reset it."""
    import torch

    return (f"graphs of kinds {list(graphs.kinds)} (rotating: True), capture "
            f"{graphs.capture_s:.3f} s, pool {graphs.pool_bytes / 2**20:.1f} MiB, max reserved "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")


def release() -> None:
    """Drop what a phase left: its runners' graphs and their pools."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _script(fi, counts) -> list:
    idle, walk, turn, idle2 = counts
    return ([fi.idle()] * idle + [fi.make(w=True)] * walk
            + [fi.make(mouse_dx=-27.0)] * turn + [fi.idle()] * idle2)


def _golden_rule(got, ref) -> tuple:
    """(share of values within 1 LSB, largest difference) of two uint8
    frames: the golden rule needs > 0.999 and <= 4."""
    import numpy as np

    diff = np.abs(got.astype(int) - ref.astype(int))
    return float((diff <= 1).mean()), int(diff.max())


def graph_phase(dev, smi: str, cfg, scene) -> None:
    """[graph]: ``[main]``'s script through ``make_scan_step`` (a captured
    graph per input kind, captured under the sync debug mode "error"),
    through ``make_step`` one call a frame (the drivers' route), and through
    a loop of ``make_step_fn`` (eager) before and after them, in this call:
    the last state and frame bitwise equal, ms/frame of each, graph replays
    and device copies a frame, capture seconds and pool bytes."""
    import torch

    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.runtime.state import FrameInputs, init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_step, make_step_fn

    t0 = time.perf_counter()
    inputs = _script(FrameInputs, SCRIPTS["main"])
    n = len(inputs)
    warm = [FrameInputs.idle(), FrameInputs.make(mouse_dx=-27.0)]   # one frame of each kind
    fresh = lambda: init_state(cfg, seed=0, device=dev)             # noqa: E731
    release()
    eager_step = make_step_fn(cfg)

    def eager():
        st = fresh()
        for inp in inputs:
            st, frame = eager_step(scene, st, inp)
        return st, frame

    (est, eframe), eager_ms = timed(eager)
    run = make_scan_step(scene, cfg)
    st = fresh()
    torch.cuda.set_sync_debug_mode("error")          # a hidden host sync raises
    try:
        run(st, warm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graphs = only_graphs(run.runner)
    replays, copies = graphs.replays, graphs.copies
    st0 = fresh()
    kernels.reset_launches()
    (st, frame), graph_ms = timed(lambda: run(st0, inputs))
    counts = dict(kernels.launches)
    replays, copies = (graphs.replays - replays) / n, (graphs.copies - copies) / n
    step = make_step(scene, cfg)
    for inp in warm:
        step(fresh(), inp)
    one = only_graphs(step.runner)
    one_copies = one.copies

    def per_frame():
        st = fresh()
        for inp in inputs:
            st, frame = step(st, inp)
        return st, frame

    (sst, sframe), step_ms = timed(per_frame)
    one_copies = (one.copies - one_copies) / n
    (est2, eframe2), eager2_ms = timed(eager)
    same = states_bitwise(st, est) and torch.equal(frame, eframe)
    same_step = states_bitwise(sst, est) and torch.equal(sframe, eframe)
    same_eager = states_bitwise(est, est2) and torch.equal(eframe, eframe2)
    sc = cfg.screen
    log(f"[graph] config_interactive {sc.width}x{sc.height} {sc.samples_per_pixel} spp, "
        f"{n} frames {SCRIPTS['main']}: make_scan_step (graphs) {graph_ms / n:.3f} ms/frame, "
        f"{replays:g} replays and {copies:.3f} device copies a frame; make_step one call a "
        f"frame {step_ms / n:.3f} ms/frame, {one_copies:.3f} device copies a frame; eager "
        f"make_step_fn loop {eager_ms / n:.3f} then {eager2_ms / n:.3f} ms/frame; last state and "
        f"frame bitwise the eager loop's: scan {same}, per frame {same_step} (eager twice "
        f"{same_eager}); launches {counts}; scan {graph_line(graphs)}; per frame graphs capture "
        f"{one.capture_s:.3f} s, pool {one.pool_bytes / 2**20:.1f} MiB; checksum "
        f"{int(frame.to(torch.int64).sum())}; {time.perf_counter() - t0:.1f} s | {smi}")
    if not (same and same_step and same_eager
            and counts == {"tracer": n, "present": n, **glue(n),
                           **nonzero(step_draws(cfg, inputs))}
            and replays == 1.0):
        raise SystemExit("[graph] FAIL")


# [bvh-kernel]: the ray sets the walk kernel is held against its plain
# version on (name -> random rays; 0 = rays of frame 1 of a configuration:
# config_bvh's and config_interactive's first segment, "bounce" the latter's
# later segments and "scale" every segment of config_scale's, its largest
# tables, as trace_paths hands them to the walk).
WALK_SETS = {"config_bvh": 0, "interactive": 0, "bounce": 0, "scale": 0,
             "mesh": 1 << 20, "cornell-spheres": 1 << 20, "leaf": 1 << 16,
             "zero-components": 1 << 16}
WALK_CONFIGS = {"config_bvh": "bvh", "interactive": "interactive", "bounce": "interactive",
                "scale": "scale"}
WALK_REPS = 10
# f32 operations counted for the walk's bound: a slab test (two an interior
# visit; the tracer counts a walked slab so) and a primitive test; and a
# sphere test (sphere_ts: the three dots, b, q, disc, the root, both roots
# and their tests) for every ray and sphere.
SLAB_OPS, PRIM_TEST_OPS, SPHERE_OPS = 30, 16, 30


def segment_rays(cfg, scene) -> tuple:
    """(segments, live, masks) of frame 1 of an idle start (``cfg``'s
    backend on ``scene``, a scene of planes without glass): the (o, d) that
    trace_paths hands the nearest-hit backend at each segment, the count of
    rays still live there and their mask, rebuilt from what the backend
    returns for every ray by trace_paths' own rule (render/tracer.py: a hit
    lives on unless it is the mirror_limit-th specular one or the
    bounce_limit-th diffuse one). A ray kept live past a segment must have
    moved in it, and a ray that moved must have been live: else
    SystemExit."""
    import torch

    from _torch_tools import frame1_rays
    from mirror_maze_tpu_torch.ops.vecmath import dot
    from mirror_maze_tpu_torch.render.intersect import BIG
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn
    from mirror_maze_tpu_torch.render.tracer import trace_paths

    p, tc = scene.prims, cfg.tracer
    if p.num_spheres or p.ior is not None:
        raise ValueError("segment_rays rebuilds liveness for planes without glass only")
    ori, dirs, key = frame1_rays(cfg, scene, with_key=True)
    nearest = scene_nearest_fn(scene, cfg)
    seen, live_counts, masks, state = [], [], [], {}

    def record(o, d, live=None):        # the list trace_paths passes: every ray is walked
        if seen:
            moved = (o != seen[-1][0]).any(dim=1)
            if not torch.equal(moved, state["was"] & moved) or not torch.equal(
                    state["alive"], state["alive"] & moved):
                raise SystemExit("segment_rays: the rebuilt liveness disagrees with the rays")
        t, idx = nearest(o, d)
        alive = state.get("alive", torch.ones_like(t, dtype=torch.bool))
        live_counts.append(int(alive.sum()))
        masks.append(alive)
        hit = alive & (t < BIG)
        ix = idx.long()
        mir, side = p.is_mirror[ix], -torch.sign(dot(d, p.normal[ix]))
        spec = hit & mir & (side != -1.0)
        mh = state.get("mh", 0) + spec.to(torch.int32)
        dc = state.get("dc", 0) + (hit & (~mir | (side == -1.0))).to(torch.int32)
        state.update(mh=mh, dc=dc, was=alive,
                     alive=hit & ~(spec & (mh >= tc.mirror_limit)) & (dc < tc.bounce_limit))
        seen.append((o.clone(), d.clone()))
        return t, idx

    trace_paths(p, ori, dirs, key, tc, record)
    return seen, live_counts, masks


@contextlib.contextmanager
def walks_by_segment(tally):
    """Within the block, the bvh_walk launches that each pipeline
    trace_paths call's backend makes (the wrapper's own count, read around
    each call) are added to ``tally``: under "first" at the first segment,
    under "later" at the others, and also under "listed" where trace_paths
    handed the backend a live-id list."""
    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.render import pipeline

    traced = pipeline.trace_paths

    def trace(prims, ori, dirs, key, tcfg, nearest_fn, *args, **kwargs):
        segment = iter(range(tcfg.max_segments))

        def nearest(o, d, live=None):
            before = kernels.launches["bvh_walk"]
            hit = nearest_fn(o, d) if live is None else nearest_fn(o, d, live=live)
            walked = kernels.launches["bvh_walk"] - before
            tally["first" if next(segment) == 0 else "later"] += walked
            tally["listed"] += walked if live is not None else 0
            return hit

        return traced(prims, ori, dirs, key, tcfg, nearest, *args, **kwargs)

    pipeline.trace_paths = trace
    try:
        yield tally
    finally:
        pipeline.trace_paths = traced


def bvh_kernel_phase(dev, smi: str) -> dict:
    """[bvh-kernel]: the walk kernel against the plain walk on eight ray
    sets, t and idx bitwise on every ray; ms per launch (CUDA events over
    WALK_REPS launches replayed from a graph; the mean over the segments of
    the bounce and scale sets), the plain walk's ms beside it, and the bound
    from the plain walk's visits; on the bounce set also with the live-id
    list (``live_walks``). Returns the kernel rows' entries by set."""
    import inspect

    import torch

    import mirror_maze_tpu_torch as P
    from _torch_tools import frame1_rays, intersect_scene, scene_rays, zero_component_rays
    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.render import intersect, upload_scene
    from mirror_maze_tpu_torch.scene import build_scene
    from mirror_maze_tpu_torch.scene.bvh import traversal_bounds
    from time_present import HBM_BYTES_PER_S, time_ms

    t0 = time.perf_counter()
    entries = {}
    for name, n in WALK_SETS.items():
        live = []
        cfg = P.NAMED_CONFIGS[WALK_CONFIGS.get(name, "bvh")]().replace(intersector="bvh")
        t_min = cfg.tracer.t_min
        if name in WALK_CONFIGS:
            scene = upload_scene(build_scene(cfg.maze), device=dev)
            if name in ("bounce", "scale"):
                batches, live, masks = segment_rays(cfg, scene)
                if name == "bounce":
                    batches, masks = batches[1:], masks[1:]
            else:
                batches = [frame1_rays(cfg, scene)]
        else:
            host = (build_scene(cfg.maze) if name == "zero-components" else
                    intersect_scene({"cornell-spheres": "spheres"}.get(name, name)))
            scene = upload_scene(host, device=dev)
            make = zero_component_rays if name == "zero-components" else scene_rays
            batches = [tuple(torch.from_numpy(x).to(dev) for x in make(host, n, seed=7))]
        p = scene.prims
        depth, leaf = traversal_bounds(p.bvh_left_first.cpu().numpy(),
                                       p.bvh_count.cpu().numpy())
        tables = intersect.bvh_tables(p, leaf)
        walk = lambda o, d: intersect.nearest_hit_bvh_kernel(   # noqa: E731
            p, o, d, t_min, depth, leaf, tables=tables)
        same, counted, launched, hits, zeros, n_rays = True, True, 0, 0, 0, 0
        ms = plain_ms = ops = 0.0
        for ori, dirs in batches:
            before = dict(kernels.launches)
            reset_walk_counters(intersect, dev)
            t, idx = walk(ori, dirs)
            launched += sum(v - before.get(k, 0) for k, v in kernels.launches.items())
            stats = {}
            (pt, pi), walk_ms = timed(lambda: intersect.nearest_hit_bvh(
                p, ori, dirs, t_min, depth, leaf, tables=tables, stats=stats))
            plain_ms += walk_ms
            same &= torch.equal(t.view(torch.int32), pt.view(torch.int32)) and torch.equal(idx, pi)
            counted &= walk_counts_hold(intersect, dev, ori.shape[0], ori.shape[0], stats)
            hits += int((pt < intersect.BIG).sum())
            zeros += int((dirs == 0).any(dim=1).sum())
            n_rays += ori.shape[0]
            del t, idx, pt, pi
            ms += time_ms(lambda: walk(ori, dirs), WALK_REPS, graph=True)
            ops += (SLAB_OPS * 2 * int(stats["interior"]) + PRIM_TEST_OPS * int(stats["tests"])
                    + SPHERE_OPS * p.num_spheres * ori.shape[0])
        k = len(batches)
        ms, plain_ms, ops = ms / k, plain_ms / k, ops / k
        per_launch = n_rays // k
        n_bytes = (tables.noderow.numel() + tables.leafpack.numel()) * 4 + per_launch * (24 + 8)
        ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        bound_ms, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
        segs = (f"; live rays at segments 1-{len(live)} of the frame (the walk runs on all "
                f"{per_launch} each segment): {live}" if live else "")
        log(f"[bvh-kernel] {name}: {n_rays} rays in {k} launch(es) ({zeros} with a zero "
            f"direction component), {p.num_planes} planes, {p.num_spheres} spheres, tree depth "
            f"{depth}, leaves of <= {leaf}; kernel bitwise the plain walk and its sphere fold "
            f"(t and idx): {same}; its counters the plain walk's counts: {counted}; "
            f"{hits / n_rays:.4f} hit; kernel {ms:.4f} ms/launch "
            f"({launched} launch(es), the fold inside); plain walk {plain_ms:.2f} ms; bound "
            f"{bound_ms:.6f} ms by {by} (operations {ops_ms:.6f}, bytes {bytes_ms:.6f}), share "
            f"{bound_ms / ms:.1%} (at most 50% under -fmad=false){segs} | {smi}")
        if not (same and counted and launched == k and hits > 0.05 * n_rays):
            raise SystemExit(f"[bvh-kernel] FAIL: {name}")
        if name == "zero-components" and zeros != n_rays:
            raise SystemExit("[bvh-kernel] FAIL: the zero-component set lost its zeros")
        entries[name] = dict(kernel="bvh_walk", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             plain_rays=per_launch, bound_ms=bound_ms, bound_by=by)
        if name == "bounce" and "live" in inspect.signature(
                intersect.nearest_hit_bvh_kernel).parameters:   # not in a port before the list
            entries["live"] = live_walks(p, tables, t_min, depth, leaf, batches, masks, smi)
        del scene, tables, batches
        release()
    log(f"[bvh-kernel] {len(WALK_SETS)} ray sets in {time.perf_counter() - t0:.1f} s")
    return entries


def reset_walk_counters(intersect, dev) -> None:
    """Zero the walk kernel's counters, where the port has them (a port
    before them, timed with ``--kernels-of``, has none)."""
    if hasattr(intersect, "counters"):
        intersect.reset_counters(dev)


def walk_counts_hold(intersect, dev, n_rays: int, grid: int, stats: dict) -> bool:
    """Whether the walk kernel's counters since the last reset are one
    launch over ``grid`` rays that walked ``n_rays`` of them with the plain
    walk's ``stats`` (its node visits); True for a port without them."""
    if not hasattr(intersect, "counters"):
        return True
    want = dict(walk_rays=n_rays, walk_nodes=int(stats["visits"]),
                walk_threads=-(-grid // 128) * 128)
    got = intersect.counters(dev)
    if got != want:
        log(f"[bvh-kernel] the walk's counters {got}, the plain walk's counts {want}")
    return got == want


def live_walks(p, tables, t_min, depth, leaf, batches, masks, smi: str) -> dict:
    """bvh_walk@live: at each segment of ``batches`` (rays) and ``masks``
    (the rays alive there), the walk kernel with the live-id list of those
    rays (in a shuffled order, as the shade kernel appends them in no fixed
    one) against the plain walk on the rays gathered: t and idx bitwise on
    every listed ray; ms a launch (graph replay), the plain walk's ms on the
    gathered rays, the bound from its visits and the listed rays' bytes.
    Returns the row's entry (means over the segments)."""
    import torch

    from mirror_maze_tpu_torch.render import intersect
    from time_present import HBM_BYTES_PER_S, time_ms

    gen = torch.Generator().manual_seed(0)
    same, counted, listed = True, True, []
    ms = plain_ms = ops = n_bytes = 0.0
    table_bytes = (tables.noderow.numel() + tables.leafpack.numel()) * 4
    for (ori, dirs), mask in zip(batches, masks):
        sel = torch.nonzero(mask)[:, 0]
        sel = sel[torch.randperm(sel.numel(), generator=gen).to(sel.device)]
        ids = torch.zeros((ori.shape[0],), dtype=torch.int32, device=ori.device)
        ids[:sel.numel()] = sel.int()
        count = torch.tensor([sel.numel()], dtype=torch.int32, device=ori.device)
        walk = lambda: intersect.nearest_hit_bvh_kernel(   # noqa: E731
            p, ori, dirs, t_min, depth, leaf, tables=tables, live=(ids, count))
        reset_walk_counters(intersect, ori.device)
        t, idx = walk()
        stats = {}
        (pt, pi), walk_ms = timed(lambda: intersect.nearest_hit_bvh(
            p, ori[sel], dirs[sel], t_min, depth, leaf, tables=tables, stats=stats))
        same &= (torch.equal(t[sel].view(torch.int32), pt.view(torch.int32))
                 and torch.equal(idx[sel], pi))
        counted &= walk_counts_hold(intersect, ori.device, sel.numel(), ori.shape[0], stats)
        del t, idx, pt, pi
        ms += time_ms(walk, WALK_REPS, graph=True)
        plain_ms += walk_ms
        ops += (SLAB_OPS * 2 * int(stats["interior"]) + PRIM_TEST_OPS * int(stats["tests"])
                + SPHERE_OPS * p.num_spheres * sel.numel())
        n_bytes += table_bytes + sel.numel() * (24 + 8 + 4) + 4
        listed.append(sel.numel())
    k = len(batches)
    ms, plain_ms, ops, n_bytes = ms / k, plain_ms / k, ops / k, n_bytes / k
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    log(f"[bvh-kernel] live: the same {k} segments with the live-id list ({listed} rays "
        f"listed of {batches[0][0].shape[0]}, shuffled): kernel bitwise the plain walk on the "
        f"listed rays gathered (t and idx): {same}; its counters the plain walk's counts on "
        f"them: {counted}; kernel {ms:.4f} ms/launch (grid sized for "
        f"every ray); plain walk on the gathered rays {plain_ms:.2f} ms; bound {bound_ms:.6f} "
        f"ms by {by} (operations {ops_ms:.6f}, bytes {bytes_ms:.6f}), share "
        f"{bound_ms / ms:.1%} | {smi}")
    if not (same and counted):
        raise SystemExit("[bvh-kernel] FAIL: live")
    return dict(kernel="bvh_walk", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                plain_rays=sum(listed) // k, bound_ms=bound_ms, bound_by=by)


# [threefry]: the raw keys (PRNGKey(0), (1), (7), (123456), (2^31 - 1) and
# one with both words above 2^31) and counts (around the kernel's block of
# 256 threads, and a large odd one) the kernel is held against its plain
# version on; the normal draw that covers the uniform's 2^23 values.
THREEFRY_KEYS = ((0, 0), (0, 1), (0, 7), (0, 123456), (0, 2 ** 31 - 1),
                 (0x9E3779B9, 0xDEADBEEF))
THREEFRY_COUNTS = (1, 3, 1023, 1024, 1025, 2 ** 20 + 7)
THREEFRY_NORMAL_COUNTS = 1 << 26
THREEFRY_BATCH = 12288
THREEFRY_REPS = 20
# int32 operations a hash (csrc/threefry.cu: 20 rounds of an add, a rotate
# and a xor; 17 adds of the key schedule; 2 xors for the third key word), and
# the FMAs of an erf_inv (erf_inv's 8, log1p's rational 11 or log's 10), two
# operations each: float32 in a normal draw (native FMAs), float64 in
# erf_inv's own output.
THREEFRY_INT_OPS = 79
ERFINV_FMAS, LOG1P_FMAS, LOG_FMAS = 8, 11, 10
# The normal draw's and erf_inv's instantiations (source IOTA, output
# NORMAL; source VALUES, output ERFINV) and the instructions counted in their
# SASS: float64 conversions and arithmetic, FMAs.
THREEFRY_SASS_KERNELS = {"normal": "threefry_kernelILi0ELi3E",
                         "erf_inv": "threefry_kernelILi3ELi4E"}
THREEFRY_SASS_OPS = ("F2F.F64.F32", "F2F.F32.F64", "DFMA", "DMUL", "DADD", "FFMA", "BRA")
# erf_inv's float32 patterns of [-1, 1] checked every run: every 127th
# (16,777,218 >= 2^24, tools/erf_inv_check.py; a card test checks them all).
ERFINV_STRIDE = 127


def threefry_bound(n_out: int, out_bytes: int, fp32_ops: int = 0) -> tuple:
    """(bound ms, by, the three times) of a draw of ``n_out`` hashes writing
    ``out_bytes``: the larger of the bytes over the memory rate and each
    operation type over its rate."""
    from time_present import HBM_BYTES_PER_S

    times = {"bytes": (out_bytes + 16) / HBM_BYTES_PER_S * 1e3,
             "int32": n_out * THREEFRY_INT_OPS / INT32_OPS_PER_S * 1e3,
             "fp32": fp32_ops / FP32_OPS_PER_S * 1e3}
    top = max(times, key=times.get)
    return times[top], "bytes" if top == "bytes" else "operations", times


def threefry_phase(dev, smi: str, cfg, listed: bool = True) -> dict:
    """[threefry]: the kernel bitwise its plain version in every output on
    THREEFRY_KEYS x THREEFRY_COUNTS, on a key batch through the jnp tracer's
    chain, on ``cfg``'s frame-1 jitter draw, on THREEFRY_NORMAL_COUNTS normal
    counts and on erf_inv's edges; the rows ``threefry@jitter`` (that draw)
    and ``threefry@normal`` (``[bench-bvh]``'s unit_sphere draw, the rays of a
    frame x 3): ms a launch replayed from a graph, the plain version's ms,
    the bound; with ``listed`` (``--kernels-of`` passes it only for a port
    that draws on a live-id list) the rows ``threefry@normal-live<it>``
    (``normal_live_rows``). Returns the rows' entries."""
    import numpy as np
    import torch

    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.runtime.state import init_state
    from mirror_maze_tpu_torch.tools import erf_inv_check
    from time_present import HBM_BYTES_PER_S, time_ms

    t0 = time.perf_counter()
    text = kernels.sass("threefry")
    if text is None:
        log("[sass] no cuobjdump in this toolkit")
    else:
        for tag, kernel in THREEFRY_SASS_KERNELS.items():
            body = next((part for part in re.split(r"\n\s*Function : ", text)
                         if re.match(r"\S*" + kernel, part)), "")
            ops = {op: len(re.findall(r"\s" + re.escape(op) + r"\b", body))
                   for op in THREEFRY_SASS_OPS}
            ops["instructions"] = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", body))
            log(f"[sass] threefry's {tag} instantiation ({kernel}): {ops}")

    def check(tag, kernel, plain) -> None:
        got, want = kernel(), plain()
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not (got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)):
            bad = int((got != want).sum()) if got.shape == want.shape else "shape"
            raise SystemExit(f"[threefry] FAIL: {tag}: {bad} elements differ from the plain "
                             "version")

    checked = 0
    for words in THREEFRY_KEYS:
        key = torch.tensor(words, dtype=torch.int64, device=dev)
        for n in THREEFRY_COUNTS:
            data = torch.arange(n, dtype=torch.int32, device=dev) * 7919 - 5
            for tag, call, kernel, plain in (
                    ("split", lambda f: f(key, n), prng.split, prng.split_plain),
                    ("fold_in int32", lambda f: f(key, data), prng.fold_in, prng.fold_in_plain),
                    ("fold_in int64", lambda f: f(key, data.long() << 20), prng.fold_in,
                     prng.fold_in_plain),
                    ("fold_in int", lambda f: f(key, n), prng.fold_in, prng.fold_in_plain),
                    ("random_bits", lambda f: f(key, (n,)), prng.random_bits,
                     prng.random_bits_plain),
                    ("uniform", lambda f: f(key, (n, 1), -1.0, 1.0), prng.uniform,
                     prng.uniform_plain),
                    ("normal", lambda f: f(key, (n,)), prng.normal, prng.normal_plain)):
                check(f"{tag} key {words} n {n}", lambda: call(kernel), lambda: call(plain))
                checked += 1
    log(f"[threefry] split, fold_in (int32, int64, int), random_bits, uniform and normal on "
        f"{len(THREEFRY_KEYS)} keys x counts {THREEFRY_COUNTS}: {checked} draws bitwise the plain "
        f"version")

    # The jnp tracer's per-ray keys (render/tracer.py:77, 157, 184).
    key = torch.tensor(THREEFRY_KEYS[-1], dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.arange(THREEFRY_BATCH, dtype=torch.int32, device=dev)
    seeds = (torch.rand(THREEFRY_BATCH, generator=gen, device=dev) * float(1 << 24)).int()
    check("per-ray keys", lambda: prng.fold_in(prng.fold_in(key, idx), seeds),
          lambda: prng.fold_in_plain(prng.fold_in_plain(key, idx), seeds))
    keys = prng.fold_in(prng.fold_in(key, idx), seeds)
    it_keys = prng.fold_in(keys, 3)
    check("bounce keys", lambda: prng.fold_in(keys, 3), lambda: prng.fold_in_plain(keys, 3))
    check("batch normal", lambda: prng.normal(it_keys, (3,)),
          lambda: prng.normal_plain(it_keys, (3,)))
    check("batch uniform", lambda: prng.uniform(prng.fold_in(it_keys, 1), ()),
          lambda: prng.uniform_plain(prng.fold_in_plain(it_keys, 1), ()))
    check("batch bits", lambda: prng.random_bits(keys[:7], (5,)),
          lambda: prng.random_bits_plain(keys[:7], (5,)))
    grid, words4 = keys[:3].reshape(3, 1, 2), torch.arange(4, device=dev) * 1000003
    check("broadcast fold_in", lambda: prng.fold_in(grid, words4),
          lambda: prng.fold_in_plain(grid, words4))
    log(f"[threefry] a [{THREEFRY_BATCH}, 2] key batch through render/tracer.py's chain "
        f"(fold_in of the ray ids and seeds, of the bounce; normal triples, a uniform a key), "
        f"batched random_bits and a [3, 1] x [4] fold_in: bitwise the plain version")

    # cfg's frame-1 jitter draw: the state's key, split by the rotation, the
    # frame folded in, split by the camera (runtime/step.py, render/pipeline.py).
    st = init_state(cfg, seed=0, device=dev)
    _, skey = prng.split(st.key)
    jkey, _ = prng.split(prng.fold_in(skey, st.frame + 1))
    sc = cfg.screen
    rays = sc.effective_chunks_per_frame * sc.pixels_per_chunk * sc.samples_per_pixel
    jshape = (sc.effective_chunks_per_frame * sc.pixels_per_chunk, sc.samples_per_pixel, 2)
    jitter = lambda: prng.uniform(jkey, jshape, -1.0, 1.0)                  # noqa: E731
    jitter_plain = lambda: prng.uniform_plain(jkey, jshape, -1.0, 1.0)      # noqa: E731
    check("jitter", jitter, jitter_plain)
    n_jit = rays * 2
    entries = {}
    ms = time_ms(jitter, THREEFRY_REPS, graph=True)
    bound_ms, by, times = threefry_bound(n_jit, 4 * n_jit)
    entries["threefry@jitter"] = dict(kernel="threefry", lib="threefry_uniform", max_abs_err=0.0,
                                      ms=ms, plain_ms=time_ms(jitter_plain, 3),
                                      bound_ms=bound_ms, bound_by=by)
    log(f"[threefry] frame 1's jitter draw of config_interactive ({n_jit} uniforms on [-1, 1), "
        f"the state's key): bitwise the plain version; kernel {ms:.4f} ms/launch replayed from "
        f"a graph, plain version {entries['threefry@jitter']['plain_ms']:.3f} ms; bound "
        f"{bound_ms:.4f} ms by {by} (bytes {times['bytes']:.4f}, int32 {times['int32']:.4f} at "
        f"{INT32_OPS_PER_S / 1e12:.2f} Tops/s), share {bound_ms / ms:.1%} | {smi}")

    # normal over THREEFRY_NORMAL_COUNTS counts, and how much of the
    # uniform's 2^23 values and erf_inv's branches it reached.
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    nkey = prng.fold_in(jkey, 5)
    check("normal 2^26", lambda: prng.normal(nkey, (THREEFRY_NORMAL_COUNTS,)),
          lambda: prng.normal_plain(nkey, (THREEFRY_NORMAL_COUNTS,)))
    u = prng.uniform(nkey, (THREEFRY_NORMAL_COUNTS,), lo, 1.0)
    covered = int(torch.unique(u).numel())
    x = u * -u
    w = -prng.log1p(x)
    branches = dict(rational=int((x.abs() < prng._LOG1P_SMALL).sum()),
                    w_ge_5=int((w >= 5.0).sum()))
    del u, x, w
    # erf_inv on all 2^23 uniforms and the edges no draw reaches: +-1, +-0,
    # 64 floats each side of w = 5 and of log1p's branch, both signs.
    m = torch.arange(2 ** 23, dtype=torch.int32, device=dev)
    lo_t = torch.tensor(lo, device=dev)
    every = torch.maximum(lo_t, ((m | 0x3F800000).view(torch.float32) - 1.0)
                          * (torch.tensor(1.0, device=dev) - lo_t) + lo_t)
    edges = [1.0, 0.0, float(np.nextafter(np.float32(1), np.float32(0))), 2.0 ** -149,
             2.0 ** -127, 2.0 ** -126, float(np.float32(2.0 ** -126) - np.float32(2.0 ** -149))]
    for centre in (np.sqrt(1.0 - np.exp(-5.0)), np.sqrt(float(prng._LOG1P_SMALL))):
        c = int(np.float32(centre).view(np.int32))
        edges += [float(v) for v in np.arange(c - 64, c + 65, dtype=np.int32).view(np.float32)]
    e = torch.tensor(edges, dtype=torch.float32, device=dev)
    values = torch.cat([every, e, -e])
    check("erf_inv", lambda: prng.erf_inv(values), lambda: prng.erf_inv_plain(values))
    log(f"[threefry] normal over {THREEFRY_NORMAL_COUNTS} counts bitwise the plain version: it "
        f"drew {covered} of the uniform's {2 ** 23} values ({covered / 2 ** 23:.4%}), "
        f"{branches['rational']} through log1p's rational branch and {branches['w_ge_5']} "
        f"through erf_inv's w >= 5 branch; erf_inv on all {2 ** 23} uniforms and {2 * len(edges)}"
        f" edges (+-1, +-0, subnormals, around w = 5 and log1p's branch): bitwise the plain "
        f"version")
    del every, values, m
    release()

    # erf_inv (its ERFINV output) on every ERFINV_STRIDE-th float32 pattern of
    # [-1, 1]: no step's native fmaf may differ from prng.fma there, and the
    # output bitwise.
    t1 = time.perf_counter()
    found = erf_inv_check.check(ERFINV_STRIDE, dev)
    stray = erf_inv_check.differing_steps(found)
    log(f"[threefry] erf_inv on every {ERFINV_STRIDE}th float32 pattern of [-1, 1] "
        f"({found['patterns']}): native fmaf differs from prng.fma at steps {stray}; the "
        f"native route against the float64 route {found['native_differs']} differ; "
        f"prng.erf_inv against erf_inv_plain {found['output_differs']} differ; "
        f"{time.perf_counter() - t1:.1f} s | {smi}")
    if stray or found["native_differs"] or found["output_differs"]:
        raise SystemExit("[threefry] FAIL: erf_inv's steps or output")
    release()

    # [bench-bvh]'s unit_sphere draw: the rays of a frame x 3 normals.
    nshape = (rays, 3)
    normal = lambda: prng.normal(nkey, nshape)                  # noqa: E731
    normal_plain = lambda: prng.normal_plain(nkey, nshape)      # noqa: E731
    check("unit_sphere normal", normal, normal_plain)
    u = prng.uniform(nkey, nshape, lo, 1.0)
    rational = int(((u * -u).abs() < prng._LOG1P_SMALL).sum())
    n_norm = rays * 3
    fma_ops = 2 * (ERFINV_FMAS * n_norm + LOG1P_FMAS * rational
                   + LOG_FMAS * (n_norm - rational))
    ms = time_ms(normal, THREEFRY_REPS, graph=True)
    bound_ms, by, times = threefry_bound(n_norm, 4 * n_norm, fma_ops)
    entries["threefry@normal"] = dict(kernel="threefry", lib="threefry_normal", max_abs_err=0.0,
                                      ms=ms, plain_ms=time_ms(normal_plain, 3),
                                      bound_ms=bound_ms, bound_by=by)
    log(f"[threefry] the unit_sphere draw of [bench-bvh] ({n_norm} normals, {rays} rays x 3): "
        f"bitwise the plain version; kernel {ms:.4f} ms/launch replayed from a graph, plain "
        f"version {entries['threefry@normal']['plain_ms']:.3f} ms; bound {bound_ms:.4f} ms by "
        f"{by} (bytes {times['bytes']:.4f}, int32 {times['int32']:.4f}, fp32 "
        f"{times['fp32']:.4f} for {fma_ops} float32 operations), share {bound_ms / ms:.1%}; "
        f"library_ms null (PyTorch's generators are Philox: no torch call computes threefry) "
        f"| {smi}")

    # erf_inv (the ERFINV output) on that draw's uniforms, beside
    # torch.special.erfinv: the same function, not XLA's polynomial bit for
    # bit. Bound: one read and one write of each value, or the float32 FMAs
    # each value's branches take (every step native) over the fp32 rate.
    check("erf_inv of the unit_sphere draw's uniforms", lambda: prng.erf_inv(u),
          lambda: prng.erf_inv_plain(u))
    lib, ours = torch.special.erfinv(u), prng.erf_inv(u)
    lib_same = float((lib.view(torch.int32) == ours.view(torch.int32)).float().mean())
    lib_ulps = int((lib.view(torch.int32).long() - ours.view(torch.int32).long()).abs().max())
    del lib, ours
    ms = time_ms(lambda: prng.erf_inv(u), THREEFRY_REPS, graph=True)
    lib_ms = time_ms(lambda: torch.special.erfinv(u), THREEFRY_REPS, graph=True)
    times = {"bytes": 8 * n_norm / HBM_BYTES_PER_S * 1e3,     # fma_ops: the same u's erf_inv
             "fp32": fma_ops / FP32_OPS_PER_S * 1e3}
    by = max(times, key=times.get)
    bound_ms = times[by]
    entries["threefry@erfinv"] = dict(kernel="threefry", lib="threefry_erf_inv",
                                      max_abs_err=0.0, ms=ms,
                                      plain_ms=time_ms(lambda: prng.erf_inv_plain(u), 3),
                                      bound_ms=bound_ms,
                                      bound_by="bytes" if by == "bytes" else "operations",
                                      library_ms=lib_ms)
    log(f"[threefry] erf_inv on the unit_sphere draw's {n_norm} uniforms: bitwise the plain "
        f"version; kernel {ms:.4f} ms/launch replayed from a graph, plain version "
        f"{entries['threefry@erfinv']['plain_ms']:.3f} ms, torch.special.erfinv {lib_ms:.4f} ms "
        f"(bitwise XLA's polynomial on {lib_same:.4%} of the values, at most {lib_ulps} ulp "
        f"apart); bound {bound_ms:.4f} ms by {by} (bytes {times['bytes']:.4f}, fp32 "
        f"{times['fp32']:.4f} for {fma_ops} operations), share {bound_ms / ms:.1%}; "
        f"{time.perf_counter() - t0:.1f} s | {smi}")
    del u
    release()
    if listed:
        entries.update(normal_live_rows(dev, smi))
    return entries


# The segments of [bench-bvh]'s frame 1 whose live-id lists the rows
# threefry@normal-live<it> draw on: the second (nearly every ray alive) and
# the seventh (a few in a hundred). An int32 pattern no float32 draw gives
# (a NaN's), pre-filled in the output, marks the rows a listed draw leaves.
NORMAL_LIVE_SEGMENTS = (1, 6)
NORMAL_LIVE_TURNS = 2
CANARY = -0x0BADF00D


def normal_live_rows(dev, smi: str) -> dict:
    """The rows ``threefry@normal-live<it>``: the normal draw of
    [bench-bvh]'s frame 1 (config_interactive with the walk) at segment it,
    on the live-id list that segment's walk reads (tests/_torch_tools.py
    segment_lists), each listed row bitwise the full draw's and every other
    row left as it was; ms a launch replayed from a graph, least of
    NORMAL_LIVE_TURNS turns with the full draw of the same key (its ms
    beside), the plain version's ms (it draws every row) and the bound of
    the listed rows' hashes and normals. Returns the rows' entries."""
    import numpy as np
    import torch

    import mirror_maze_tpu_torch as P
    from _torch_tools import frame1_rays, listed_normal, segment_lists
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.render import upload_scene
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn
    from mirror_maze_tpu_torch.scene import build_scene
    from time_present import time_ms

    t0 = time.perf_counter()
    cfg = P.NAMED_CONFIGS["interactive"]().replace(intersector="bvh")
    scene = upload_scene(build_scene(cfg.maze), device=dev)
    ori, dirs, key = frame1_rays(cfg, scene, with_key=True)
    n_rays = ori.shape[0]
    _, lists = segment_lists(scene.prims, ori, dirs, key, cfg.tracer,
                             scene_nearest_fn(scene, cfg))
    counts = {it: int(rows[1]) for it, rows in sorted(lists.items())}
    del scene, ori, dirs
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    shape = (n_rays, 3)
    entries = {}
    for it in NORMAL_LIVE_SEGMENTS:
        rows = lists[it]
        n = counts[it]
        seg_key = prng.fold_in(key, it)
        full = prng.normal(seg_key, shape).view(torch.int32)
        got = listed_normal(seg_key, shape, rows, CANARY).view(torch.int32)
        listed = torch.zeros(n_rays, dtype=torch.bool, device=dev)
        listed[rows[0][:n].long()] = True
        if not (torch.equal(got[listed], full[listed]) and bool((got[~listed] == CANARY).all())):
            raise SystemExit(f"[threefry] FAIL: the listed normal draw at segment {it} is not "
                             "the full draw on its rows alone")
        u = prng.uniform(seg_key, shape, lo, 1.0)[listed]
        rational = int(((u * -u).abs() < prng._LOG1P_SMALL).sum())
        n_norm = 3 * n
        fma_ops = 2 * (ERFINV_FMAS * n_norm + LOG1P_FMAS * rational
                       + LOG_FMAS * (n_norm - rational))
        del full, got, u
        turns = {"full": [], "listed": []}
        for _ in range(NORMAL_LIVE_TURNS):
            turns["full"].append(time_ms(lambda: prng.normal(seg_key, shape), THREEFRY_REPS,
                                         graph=True))
            turns["listed"].append(time_ms(lambda: prng.normal(seg_key, shape, rows=rows),
                                           THREEFRY_REPS, graph=True))
        ms, full_ms = min(turns["listed"]), min(turns["full"])
        # The listed rows' normals written and their ids read, the count read.
        bound_ms, by, times = threefry_bound(n_norm, 4 * n_norm + 4 * n + 4, fma_ops)
        row = f"threefry@normal-live{it}"
        entries[row] = dict(kernel="threefry", lib="threefry_normal_listed", max_abs_err=0.0,
                            ms=ms,
                            plain_ms=time_ms(lambda: prng.normal_plain(seg_key, shape), 3),
                            bound_ms=bound_ms, bound_by=by, full_ms=full_ms, listed=n)
        log(f"[threefry] {row}: [bench-bvh]'s frame-1 normal draw at segment {it} on its "
            f"live-id list ({n} of {n_rays} rays, {n / n_rays:.4%}): the listed rows bitwise "
            f"the full draw's, the other {n_rays - n} untouched; kernel {ms:.5f} ms/launch "
            f"replayed from a graph against the full draw's {full_ms:.5f} (turns: listed "
            f"{[round(x, 5) for x in turns['listed']]}, full "
            f"{[round(x, 5) for x in turns['full']]}); bound {bound_ms:.5f} ms by {by} (bytes "
            f"{times['bytes']:.5f}, int32 {times['int32']:.5f}, fp32 {times['fp32']:.5f}), "
            f"share {bound_ms / ms:.1%} | {smi}")
    log(f"[threefry] the live-id lists of [bench-bvh]'s frame 1 by segment: {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    del lists
    release()
    return entries


# [frame-glue]: the inputs the glue kernels are held on (tests/_torch_tools.py
# glue_inputs): [main]'s frame 1, a W move into a wall and a free one, a
# turning frame, config_scale's frame 1 (a window of 8,040 ids), [bands]'
# second band (row0 540), config_fuzzy's frame 1 (the seed row), config_v0
# (1 spp) and config_bvh (4 spp) through the jnp tracer, config_scale at
# 7680x4320 (a window of 32,400 ids: frame_setup's tiled route) and
# config_interactive at 4,096 spp (resolve's pieces route).
GLUE_INPUTS = ("interactive:frame1", "interactive:collide", "interactive:walk",
               "interactive:turn", "scale:frame1", "bands:frame1", "fuzzy:frame1", "v0:frame1",
               "bvh:frame1", "scale-8k:frame1", "spp4096:frame1")
# The rows: (tag, input, the kernels timed on it).
GLUE_ROWS = (("", "interactive:frame1", ("camera_rays", "resolve", "frame_setup")),
             ("@scale", "scale:frame1", ("camera_rays", "resolve", "frame_setup")),
             ("@8k", "scale-8k:frame1", ("frame_setup",)),
             ("@4096spp", "spp4096:frame1", ("resolve",)))
GLUE_REPS = 20
# frame_setup's integer operations for its bound: an id's Morton code and its
# decode (two spreads, two compacts, the modulo and the division), a
# comparison of the sort, a leaf box's test (six compares, five ands). A
# sorted window of n distinct codes is charged n * ceil(log2 n) comparisons,
# what a merge sort of them makes (within 1.45 n of log2(n!), the fewest any
# comparison sort can make), not the kernel's network or merge passes.
SETUP_ID_OPS, SETUP_SORT_OPS, SETUP_LEAF_OPS = 40, 1, 11


def frame_glue_phase(dev, smi: str) -> dict:
    """[frame-glue]: frame_setup, camera_rays and resolve each bitwise its
    plain version on every buffer it writes, on every input of GLUE_INPUTS;
    then the rows ``frame_setup``, ``frame_setup@scale``, ``camera_rays``,
    ``camera_rays@scale``, ``resolve`` and ``resolve@scale`` on [main]'s and
    config_scale's frame 1, ``frame_setup@8k`` (config_scale at 7680x4320)
    and ``resolve@4096spp`` (config_interactive at 4,096 spp): ms a launch
    from CUDA events over graph-replayed launches, the plain version's ms,
    the bound. frame_setup's rows also
    give the floor of a one-block launch replayed from a graph (a
    one-element in-place add, timed alone the same way): its share is
    against that floor plus its operations bound. Returns the rows'
    entries."""
    import dataclasses

    import torch

    from _torch_tools import frame_light, glue_check, glue_inputs
    from mirror_maze_tpu_torch.render import frame_glue
    from mirror_maze_tpu_torch.runtime import step
    from time_present import HBM_BYTES_PER_S, time_ms

    for name in GLUE_INPUTS:
        t0 = time.perf_counter()
        cfg, scene, state, row, grid, row0, nearest = glue_inputs(name, dev)
        out = glue_check(cfg, scene, state, row, grid, row0, nearest)
        sc = cfg.screen
        rays = grid.effective_chunks_per_frame * sc.pixels_per_chunk * sc.samples_per_pixel
        bad = {k: v for k, v in out.items() if v}
        log(f"[frame-glue] {name}: {sc.width}x{sc.height} {sc.samples_per_pixel} spp, "
            f"intersector {cfg.intersector}, window of {grid.effective_chunks_per_frame} ids "
            f"(sorted {sc.sort_chunk_window}, grid {grid.chunks_x}x{grid.chunks_y}, row0 {row0}), "
            f"{rays} rays, input row {row.tolist()}: frame_setup, camera_rays and resolve "
            f"bitwise their plain versions on {len(out)} buffers: {not bad}"
            f"{'' if not bad else f' (elements differing {bad})'}; "
            f"{time.perf_counter() - t0:.1f} s | {smi}")
        if bad:
            raise SystemExit(f"[frame-glue] FAIL: {name}: {bad}")
        del cfg, scene, state, out
        release()

    # The launch floor, timed as the rows are: the least of three graph
    # replays of GLUE_REPS one-element adds (a single reading caught a 5x
    # outlier once).
    one = torch.zeros(1, device=dev)
    floors = [time_ms(lambda: one.add_(1), GLUE_REPS, graph=True) for _ in range(3)]
    floor_ms = min(floors)
    log(f"[frame-glue] launch floor: a one-element in-place add {floor_ms:.5f} ms/launch "
        f"replayed from a graph (least of {', '.join(f'{f:.5f}' for f in floors)}) | {smi}")
    entries = {}
    for tag, name, timed_kernels in GLUE_ROWS:
        cfg, scene, state, row, grid, row0, nearest = glue_inputs(name, dev)
        sc, spp = cfg.screen, cfg.screen.samples_per_pixel
        n = grid.effective_chunks_per_frame
        k = n * sc.pixels_per_chunk
        r = k * spp
        setup = step.frame_setup_plain(scene, cfg, state, row, n, grid)
        cam = state._replace(cam_center=setup.center).camera(cfg)
        win = frame_glue.Window(setup.ids, grid, row0)
        rays = frame_glue.pinhole_rays_plain(cam, win, setup.jkey, cfg, scene.noise)
        light = frame_light(cfg, scene, cam, rays, setup, nearest)
        del rays
        screen = state.screen.clone()
        timed_fns = {
            "camera_rays": (lambda: frame_glue.pinhole_rays_kernel(cam, win, setup.jkey, cfg,
                                                                   scene.noise),
                            lambda: frame_glue.pinhole_rays_plain(cam, win, setup.jkey, cfg,
                                                                  scene.noise)),
            "resolve": (lambda: frame_glue.resolve_kernel(light, spp, screen, setup.ids),
                        lambda: frame_glue.resolve_plain(light, spp, state.screen, setup.ids)),
        }
        ids_bytes = 4 * n
        bytes_of = {"camera_rays": 24 * r + ids_bytes + (4 * r if cfg.tracer.noise_rng else 0),
                    "resolve": 12 * r + 12 * k + ids_bytes}
        ops_of = {"camera_rays": 2 * r * THREEFRY_INT_OPS, "resolve": 0}
        timed_fns["frame_setup"] = (
            lambda: step.frame_setup_kernel(scene, cfg, state, row, n, grid),
            lambda: step.frame_setup_plain(scene, cfg, state, row, n, grid))
        compares = n * (n - 1).bit_length() if sc.sort_chunk_window else 0
        leaves = scene.leaf_min.shape[0]
        bytes_of["frame_setup"] = 2 * ids_bytes + 24 * leaves + 96
        ops_of["frame_setup"] = (9 * THREEFRY_INT_OPS + SETUP_ID_OPS * n
                                 + SETUP_SORT_OPS * compares + SETUP_LEAF_OPS * leaves)
        for kernel in timed_kernels:
            fn, plain = timed_fns[kernel]
            ms = time_ms(fn, GLUE_REPS, graph=True)
            plain_ms = time_ms(plain, 3)
            by_bytes = bytes_of[kernel] / HBM_BYTES_PER_S * 1e3
            by_ops = ops_of[kernel] / INT32_OPS_PER_S * 1e3
            bound_ms, by = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
            entries[kernel + tag] = dict(kernel=kernel, lib=kernel, max_abs_err=0.0, ms=ms,
                                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
            latency = ""
            if kernel == "frame_setup":
                # The same launch without the sort flag: the window copied.
                unsorted = cfg.replace(screen=dataclasses.replace(sc, sort_chunk_window=False))
                unsorted_ms = time_ms(
                    lambda: step.frame_setup_kernel(scene, unsorted, state, row, n, grid),
                    GLUE_REPS, graph=True)
                entries[kernel + tag]["floor_ms"] = floor_ms
                latency = (f" (latency-bound: {(floor_ms + bound_ms) / ms:.1%} against the "
                           f"launch floor {floor_ms:.5f} ms plus the bound; without the sort "
                           f"{unsorted_ms:.5f} ms)")
            log(f"[frame-glue] {kernel + tag} on {name} ({r} rays, {n} ids): kernel {ms:.5f} "
                f"ms/launch replayed from a graph, plain version {plain_ms:.3f} ms; bound "
                f"{bound_ms:.5f} ms by {by} (bytes {by_bytes:.5f}, int32 {by_ops:.5f}), share "
                f"{bound_ms / ms:.1%}{latency} | {smi}")
        del cfg, scene, state, setup, light, screen, timed_fns
        release()
    del one
    return entries


# [scale-8k] / [spp4096]: the engine past the glue kernels' one-block limits
# (tests/_torch_tools.py BIG): config_scale at 7680x4320 and
# config_interactive at 4,096 spp, an idle and a turning frame each; and an
# offline render of BIG_RENDER_PIXELS pixels at 4,096 spp.
BIG_PATHS = ("scale-8k", "spp4096")
BIG_RENDER_PIXELS = 64


def big_phases(dev, smi: str) -> dict:
    """[scale-8k] and [spp4096]: each configuration's two frames through
    make_scan_step (graph replays after a first call that captures them)
    and through the eager loop (make_scan_step_fn): state and frame bitwise,
    one tracer, present, frame_setup, camera_rays and resolve a frame, the
    permutation's draws; [spp4096] then renders BIG_RENDER_PIXELS pixels
    through render_pixels, its colours bitwise resolve_plain of the same
    light. Returns each path's launch counts."""
    import torch

    from _torch_tools import big_config
    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.render.frame_glue import resolve_plain
    from mirror_maze_tpu_torch.render.pipeline import render_pixels, trace_samples, tracer_seed
    from mirror_maze_tpu_torch.render.scenebuf import upload_scene
    from mirror_maze_tpu_torch.runtime.state import FrameInputs, init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_scan_step_fn, merge_passes
    from mirror_maze_tpu_torch.scene import build_scene

    out = {}
    frames = [FrameInputs.idle(), FrameInputs.make(mouse_dx=-27.0)]
    for path in BIG_PATHS:
        t0 = time.perf_counter()
        release()
        cfg = big_config(path)
        scene = upload_scene(build_scene(cfg.maze), device=dev)
        run = make_scan_step(scene, cfg)
        run(init_state(cfg, device=dev), frames)                   # first-call costs, captures
        torch.cuda.synchronize()
        st0 = init_state(cfg, seed=0, device=dev)
        kernels.reset_launches()
        (st, frame), ms = timed(lambda: run(st0, frames))
        counts = dict(kernels.launches)
        graphs = graph_line(only_graphs(run.runner))
        (est, eframe), eager_ms = timed(lambda: make_scan_step_fn(cfg, len(frames))(
            scene, init_state(cfg, seed=0, device=dev), frames))
        same = states_bitwise(st, est) and torch.equal(frame, eframe)
        sc = cfg.screen
        n = sc.effective_chunks_per_frame
        rays = n * sc.pixels_per_chunk * sc.samples_per_pixel
        merges = merge_passes(n, sc.sort_chunk_window)
        want = {"tracer": len(frames), "present": len(frames), **glue(len(frames)),
                **nonzero({"frame_setup_merge": len(frames) * merges})}
        lit = int(frame.to(torch.int64).sum())
        log(f"[{path}] config_{'scale' if path == 'scale-8k' else 'interactive'} "
            f"{sc.width}x{sc.height} {sc.samples_per_pixel} spp, {len(frames)} frames (idle, "
            f"turn), a window of {n} ids (grid {sc.chunks_x}x{sc.chunks_y}), {rays} rays/frame: "
            f"{ms / len(frames):.1f} ms/frame, {rays / (ms / len(frames)) / 1e3:.2f} Mrays/s, "
            f"checksum {lit}; launches {counts}; eager loop {eager_ms / len(frames):.1f} "
            f"ms/frame, make_scan_step == eager bitwise {same}; {graphs}; "
            f"{time.perf_counter() - t0:.1f} s | {smi}")
        # Two frames light 2/64 of the screen: the frame must not be blank.
        if not (same and holds(counts, want, True) and lit > 0
                and {k: counts.get(k, 0) for k in ("threefry", "threefry_uniform")}
                == step_draws(cfg, frames) and bool(torch.isfinite(st.screen).all())):
            raise SystemExit(f"[{path}] FAIL")
        out[path] = counts
        del run, st, st0, frame, est, eframe
        if path == "spp4096":
            t0 = time.perf_counter()
            side = int(BIG_RENDER_PIXELS ** 0.5)
            ys, xs = torch.meshgrid(torch.arange(side, device=dev) + sc.height // 2,
                                    torch.arange(side, device=dev) + sc.width // 2,
                                    indexing="ij")
            pix = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.int32)
            cam = init_state(cfg, device=dev).camera(cfg)
            key = prng.PRNGKey(5, device=dev)
            kernels.reset_launches()
            colours = render_pixels(scene, cam, pix, key, cfg)
            counts = dict(kernels.launches)
            jkey, tkey = prng.split(key)
            light = trace_samples(scene, cam, pix, jkey, tkey, tracer_seed(tkey), cfg)
            same = torch.equal(colours.view(torch.int32),
                               resolve_plain(light, sc.samples_per_pixel).view(torch.int32))
            log(f"[spp4096-render] render_pixels of {pix.shape[0]} pixels at "
                f"{sc.samples_per_pixel} spp ({light.shape[0]} rays): colours bitwise "
                f"resolve_plain of the same light {same}, mean {float(colours.mean()):.4f}; "
                f"launches {counts}; {time.perf_counter() - t0:.1f} s | {smi}")
            if not (same and holds(counts, {"tracer": 1, **glue(renders=1)}, True)
                    and bool(torch.isfinite(colours).all())):
                raise SystemExit("[spp4096-render] FAIL")
            del light, colours
        del scene
        release()
    return out


# [shade]: the sets the shade kernel is held against shade_segment_plain on,
# at every segment: name -> (configuration or Cornell box variant, tracer
# changes). A configuration's set is its frame-1 rays (config_interactive's
# is [bench-bvh]'s frame); a Cornell box's the GALLERY_BATCH-th block of
# GALLERY_ROWS pixel rows of the 1024x1024, 64 spp gallery frame. Every set
# runs the bvh backend.
SHADE_SETS = {
    "bench-bvh": ("interactive", {}),
    "cornell-spheres": ("spheres", {}),
    "cornell-glass": ("glass", dict(fresnel=True)),
    "cornell-glass-no-fresnel": ("glass", dict(fresnel=False)),
    "cornell-checker": ("checker", {}),
    "sky": ("interactive", dict(sky_strength=0.7)),
    "fuzzy": ("fuzzy", {}),
}
SHADE_REPS = 10
# f32 operations of shade_segment_plain a ray in the planes-only instance
# (the row's; the plain version computes every stage for every ray): the
# side's dot and sign (7), the unit vector from the draw (x * x, the root,
# its clamp, three divisions: 6; the two float64 FMAs not counted), the
# scatter (n * side, the add, normalize: 15), the emission (9) and albedo
# (3), the mirror tint (6), the reflection (12) and its normalize (9), the
# sky term (pow, 9), the advance (6).
SHADE_PLAIN_OPS = 83
# Bytes of a ray's path state (o, d, thr, light, mh, dc, alive), which an
# alive ray reads and the kernel writes back.
SHADE_STATE_BYTES = 4 * 3 * 4 + 2 * 4 + 1


def shade_phase(dev, smi: str) -> dict:
    """[shade]: the shade kernel bitwise shade_segment_plain at every
    segment of each of SHADE_SETS, at full width (o, d, thr, light, mh, dc,
    alive; the live count and the live-id list), and on directions at the
    sign's and clamp's edges; the row ``shade@interactive`` from the
    bench-bvh set: ms a launch replayed from a graph (out of place, the
    count reset before each launch, the reset's own time taken off), the
    plain version's ms and the bound, means over the 13 segments. Returns
    the row's entry."""
    import dataclasses

    import torch

    import mirror_maze_tpu_torch as P
    from _torch_tools import (
        bits,
        cornell_scene,
        edge_segment,
        frame1_inputs,
        gallery_config,
        shade_records_ok,
        shade_segments,
        textured_cornell,
    )
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.render import make_camera, upload_scene
    from mirror_maze_tpu_torch.render.intersect import BIG
    from mirror_maze_tpu_torch.render.pipeline import (
        camera_rays,
        frame_row_batches,
        scene_nearest_fn,
    )
    from mirror_maze_tpu_torch.render.tracer import (
        PathState,
        shade_segment_kernel,
        shade_segment_plain,
    )
    from mirror_maze_tpu_torch.scene import build_scene
    from time_present import HBM_BYTES_PER_S, time_ms

    t0 = time.perf_counter()
    failed, per_segment = [], []

    def timer(prims, tc):
        n_table = sum(x.numel() * x.element_size() for x in (
            prims.normal, prims.color, prims.emission, prims.is_mirror))

        def before(it, st, t, idx, g, u3):
            n_rays = st.o.shape[0]
            out = PathState(*(x.clone() for x in st))
            ids = torch.empty((n_rays,), dtype=torch.int32, device=dev)
            count = torch.zeros((1,), dtype=torch.int32, device=dev)

            def launch():
                count.zero_()
                shade_segment_kernel(prims, tc, st, t, idx, g, u3, it, live_out=(ids, count),
                                     out=out)

            both = time_ms(launch, SHADE_REPS, graph=True)
            reset = time_ms(count.zero_, SHADE_REPS, graph=True)
            want, plain = timed(lambda: shade_segment_plain(prims, tc, st, t, idx, g, u3, it))
            live = int(st.alive.sum())
            hit = int((st.alive & (t < BIG)).sum())
            diffuse, kept = int((want.dc - st.dc).sum()), int(want.alive.sum())
            n_bytes = (n_table + live * (2 * SHADE_STATE_BYTES + 4) + hit * 4 + diffuse * 12
                       + kept * 4 + (n_rays - live))
            per_segment.append(dict(ms=both - reset, both=both, reset=reset, plain=plain,
                                    bytes=n_bytes, ops=n_rays * SHADE_PLAIN_OPS))
            del out, want

        return before

    for name, (kind, extra) in SHADE_SETS.items():
        t1 = time.perf_counter()
        if kind in P.NAMED_CONFIGS:
            cfg = P.NAMED_CONFIGS[kind]()
            scene = upload_scene(build_scene(cfg.maze), device=dev)
        else:
            cfg = gallery_config(GALLERY_SIZE, GALLERY_SPP)
            host = textured_cornell("blocks") if kind == "checker" else cornell_scene(kind)
            scene = upload_scene(host, device=dev)
        cfg = dataclasses.replace(cfg, tracer=dataclasses.replace(cfg.tracer, **extra))
        cfg = cfg.replace(intersector="bvh")
        if kind in P.NAMED_CONFIGS:
            ori, dirs, key, seed_row = frame1_inputs(cfg, scene)
        else:
            cam = make_camera(cfg.camera, 1.0, dev)
            pix, bkey = list(frame_row_batches(cfg, prng.PRNGKey(0, device=dev), GALLERY_ROWS,
                                               dev))[GALLERY_BATCH]
            ori, dirs, key, seed_row = camera_rays(cam, pix, bkey, cfg, scene.noise)
        p, tc = scene.prims, cfg.tracer
        records, st = shade_segments(p, tc, ori, dirs, key, scene_nearest_fn(scene, cfg),
                                     seed_row=seed_row,
                                     before=timer(p, tc) if name == "bench-bvh" else None)
        ok = shade_records_ok(records)
        stages = [k for k, on in (("spheres", p.num_spheres), ("textures", p.tex is not None),
                                  ("glass", p.ior is not None or p.sph_ior is not None),
                                  ("fresnel", tc.fresnel and (p.ior is not None
                                                              or p.sph_ior is not None)),
                                  ("seed row", seed_row is not None),
                                  ("sky", tc.sky_strength > 0)) if on]
        bad = [r for r in records if r["diff"] or r["count"] != r["live_out"] or not r["ids"]]
        log(f"[shade] {name}: {ori.shape[0]} rays, {tc.max_segments} segments, stages "
            f"{stages or ['planes only']}; alive at each segment "
            f"{[r['live_in'] for r in records]}; the kernel bitwise shade_segment_plain (o, d, "
            f"thr, light, mh, dc, alive) with its live count and id list right at every "
            f"segment: {ok}{'' if ok else f' (segments at fault: {bad[:4]})'}; light mean "
            f"{float(st.light.mean()):.6f}; {time.perf_counter() - t1:.1f} s | {smi}")
        if not ok or float(st.light.mean()) <= 0.0:
            failed.append(name)
        del scene, ori, dirs, st, records
        release()

    # The sign's and clamp's edges: directions along the hit plane (d.n = +0
    # and -0) and NaN ones, in the glass instance with Fresnel and the sky.
    prims = upload_scene(cornell_scene("glass"), device=dev).prims
    tc = P.TracerConfig(bounce_limit=3, mirror_limit=3, fresnel=True, sky_strength=0.5)
    st, t, idx, g = edge_segment(prims, 1 << 16, dev)
    u3 = prng.uniform(prng.PRNGKey(2, device=dev), (1 << 16,))
    want = shade_segment_plain(prims, tc, st, t, idx, g, u3, 1)
    got = shade_segment_kernel(prims, tc, st, t, idx, g, u3, 1)
    differ = {f: int((bits(getattr(got, f)) != bits(getattr(want, f))).sum())
              for f in PathState._fields}
    edges = not any(differ.values())
    log(f"[shade] edges: 65,536 rays hitting plane 0 at t = 1, a quarter along it (d.n = +0), "
        f"a quarter along it with -0 products (d.n = -0), a quarter with a NaN direction: "
        f"bitwise the plain version {edges} (values differing by field: {differ})")
    if not edges:
        failed.append("edges")
    if failed:
        raise SystemExit(f"[shade] FAIL: {failed}")

    k = len(per_segment)
    mean = {f: sum(r[f] for r in per_segment) / k for f in per_segment[0]}
    ops_ms = mean["ops"] / FP32_OPS_PER_S * 1e3
    bytes_ms = mean["bytes"] / HBM_BYTES_PER_S * 1e3
    bound_ms, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    log(f"[shade] shade@interactive ([bench-bvh]'s frame-1 rays at its {k} segments): kernel "
        f"{mean['ms']:.5f} ms/launch (mean; graph replay of {SHADE_REPS} launches out of place, "
        f"each after a 4-byte count reset: {mean['both']:.5f}, less the resets alone "
        f"{mean['reset']:.5f}; by segment {[round(r['ms'], 5) for r in per_segment]}); plain "
        f"version {mean['plain']:.3f} ms; bound {bound_ms:.6f} ms by {by} (bytes "
        f"{bytes_ms:.6f} for {mean['bytes']:.0f} B, operations {ops_ms:.6f} for the plain "
        f"version's {SHADE_PLAIN_OPS} a ray), share {bound_ms / mean['ms']:.1%}; library_ms "
        f"null (no torch call computes a segment); {time.perf_counter() - t0:.1f} s | {smi}")
    return {"shade@interactive": dict(kernel="shade", max_abs_err=0.0, ms=mean["ms"],
                                      plain_ms=mean["plain"], bound_ms=bound_ms, bound_by=by)}


def jnp_phases(dev, smi: str) -> dict:
    """The phases of the jnp tracer's backends (with the walk kernel), the
    offline path and the checkpoints; any failure ends the run with
    SystemExit. Returns the walk kernel's entries by ray set
    (``bvh_kernel_phase``) and the walk launches of ``[bvh]`` and
    ``[bands-bvh]``."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    import mirror_maze_tpu_torch as P
    from _torch_tools import frame1_rays, golden_config, golden_script
    from mirror_maze_tpu_torch import bench, kernels
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.render import campath, intersect, make_camera, upload_scene
    from mirror_maze_tpu_torch.parallel import shard
    from mirror_maze_tpu_torch.render.pipeline import frame_row_batches, render_full_frame
    from mirror_maze_tpu_torch.runtime.graph import StepRunner
    from mirror_maze_tpu_torch.runtime.loop import run_scripted
    from mirror_maze_tpu_torch.runtime.state import (
        EngineState,
        FrameInputs,
        init_state,
        load_state,
        save_state,
    )
    from mirror_maze_tpu_torch.runtime.step import (
        derive_traversal_bounds,
        make_scan_step,
        make_scan_step_fn,
        run_frames,
    )
    from mirror_maze_tpu_torch.scene import build_scene
    from mirror_maze_tpu_torch.utils import imageio

    turning = FrameInputs.make(mouse_dx=-27.0)

    # [golden-brute]: the brute backend's frame and script against the
    # committed goldens.
    t0 = time.perf_counter()
    gcfg = golden_config().replace(intersector="brute")
    gscene = upload_scene(build_scene(gcfg.maze), device=dev)
    gcam = make_camera(gcfg.camera, gcfg.screen.width / gcfg.screen.height, dev)
    g_batches = len(list(frame_row_batches(gcfg, prng.PRNGKey(0, device=dev), 64, dev)))
    kernels.reset_launches()
    img = render_full_frame(gscene, gcam, prng.PRNGKey(0, device=dev), gcfg)
    img = img.clamp(0, 1).cpu().numpy()
    _, gframe = run_scripted(gscene, gcfg, inputs=golden_script(FrameInputs))
    counts = dict(kernels.launches)
    with np.load(os.path.join(ROOT, "tests", "goldens", "frame_brute.npz")) as z:
        ref = z["img"]
    close, mean_diff = float(np.isclose(img, ref, atol=2e-3).mean()), abs(img.mean() - ref.mean())
    with np.load(os.path.join(ROOT, "tests", "goldens", "script_brute.npz")) as z:
        within, worst = _golden_rule(gframe, z["img"])
    log(f"[golden-brute] intersector brute on the card: frame vs tests/goldens/frame_brute.npz "
        f"{close:.6f} of values within 2e-3 (need > 0.999), mean diff {mean_diff:.2e} (need "
        f"<= 1e-4); 28-frame script vs script_brute.npz {within:.6f} within 1 LSB (need > "
        f"0.999), max diff {worst} (need <= 4); launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (close > 0.999 and mean_diff <= 1e-4 and within > 0.999 and worst <= 4
            and holds(counts, {"present": 28, **glue(28, g_batches),
                               "shade": (g_batches + 28) * gcfg.tracer.max_segments}, True)):
        raise SystemExit("[golden-brute] FAIL")

    # [v0]: config_v0 at full size, on the card and on the CPU.
    t0 = time.perf_counter()
    cfg = P.NAMED_CONFIGS["v0"]()
    sc = cfg.screen
    inputs = _script(FrameInputs, JNP_SCRIPTS["v0"])
    release()
    v0_scene = upload_scene(build_scene(cfg.maze), device=dev)
    run = make_scan_step(v0_scene, cfg)
    run(init_state(cfg, device=dev), [inputs[0], turning])       # first-call costs
    torch.cuda.synchronize()
    st0 = init_state(cfg, seed=0, device=dev)
    kernels.reset_launches()
    (st, frame), ms = timed(lambda: run(st0, inputs))
    counts = dict(kernels.launches)
    n = len(inputs)
    (est, eframe), eager_ms = timed(lambda: make_scan_step_fn(cfg, n)(
        v0_scene, init_state(cfg, seed=0, device=dev), inputs))
    same = states_bitwise(st, est) and torch.equal(frame, eframe)
    rays = sc.effective_chunks_per_frame * sc.pixels_per_chunk * sc.samples_per_pixel
    checksum = int(frame.to(torch.int64).sum())
    t_cpu = time.perf_counter()
    cst, cframe = make_scan_step(upload_scene(build_scene(cfg.maze), device="cpu"), cfg)(
        init_state(cfg, seed=0, device="cpu"), inputs)
    t_cpu = time.perf_counter() - t_cpu
    within, worst = _golden_rule(frame.cpu().numpy(), cframe.numpy())
    same_state = all(torch.equal(getattr(st, f).cpu(), getattr(cst, f))
                     for f in ("perm", "cursor", "key", "frame"))
    cam_diff = float((st.cam_center.cpu() - cst.cam_center).abs().max())
    log(f"[v0] config_v0 {sc.width}x{sc.height} {sc.samples_per_pixel} spp, intersector "
        f"{cfg.intersector}, {n} frames {JNP_SCRIPTS['v0']}, {rays} rays/frame: "
        f"{ms / n:.3f} ms/frame, {rays / (ms / n) / 1e3:.2f} Mrays/s, checksum {checksum}; the "
        f"same script on the CPU ({t_cpu:.1f} s): {within:.6f} within 1 LSB, max diff {worst}, "
        f"queue/cursor/key/frame equal {same_state}, camera diff {cam_diff:.1e}; launches "
        f"{counts}; eager loop {eager_ms / n:.3f} ms/frame, graph == eager bitwise {same}; "
        f"{graph_line(only_graphs(run.runner))}; {time.perf_counter() - t0:.1f} s | {smi}")
    if not (within > 0.999 and worst <= 4 and same_state and cam_diff <= 1e-6 and same
            and float(frame.float().mean()) > 0.1
            and holds(counts, {"present": n, "shade": n * cfg.tracer.max_segments, **glue(n)},
                      True)):
        raise SystemExit("[v0] FAIL")

    # [bvh-kernel]: the walk kernel against the plain walk.
    walk_entries = bvh_kernel_phase(dev, smi)

    # [shade]: the shade kernel against its plain version.
    shade_entries = shade_phase(dev, smi)

    # [bvh] and [exact]: config_bvh's scene (8x8 maze, 512x384, 4 spp, 5 + 4
    # bounces) with the traversal (the walk kernel) and with the dense exact
    # backend; both replay graphs, with no host sync in the frames.
    base = P.NAMED_CONFIGS["bvh"]()
    bscene = upload_scene(build_scene(base.maze), device=dev)
    inputs = _script(FrameInputs, JNP_SCRIPTS["bvh"])
    n = len(inputs)
    sc = base.screen
    rays = sc.effective_chunks_per_frame * sc.pixels_per_chunk * sc.samples_per_pixel
    last, path_launches = {}, {}
    for backend in ("bvh", "exact"):
        t0 = time.perf_counter()
        cfg = base.replace(intersector=backend)
        release()
        run = make_scan_step(bscene, cfg)
        run(init_state(cfg, device=dev), [inputs[0], turning])  # first-call costs, captures
        torch.cuda.synchronize()
        st0 = init_state(cfg, seed=0, device=dev)
        kernels.reset_launches()
        intersect.walk_counts.clear()
        (st, frame), ms = timed(lambda: no_sync(lambda: run(st0, inputs)))
        counts, walks = dict(kernels.launches), dict(intersect.walk_counts)
        (est, eframe), eager_ms = timed(lambda: make_scan_step_fn(cfg, n)(
            bscene, init_state(cfg, seed=0, device=dev), inputs))
        same = states_bitwise(st, est) and torch.equal(frame, eframe)
        graphs = only_graphs(run.runner)
        want = {"present": n, "shade": n * cfg.tracer.max_segments, **glue(n)}
        draws = {"threefry_normal": n,
                 "threefry_normal_listed": n * (cfg.tracer.max_segments - 1)}
        walked = ""
        if backend == "bvh":
            want["bvh_walk"] = n * cfg.tracer.max_segments
            path_launches["bvh"] = counts.get("bvh_walk", 0)
            walked = (f", 0 host syncs a frame (the call ran under the sync debug mode "
                      f"'error'; plain walks {walks.get('walks', 0)}), "
                      f"{cfg.tracer.max_segments} walk launches a frame, bounds "
                      f"{derive_traversal_bounds(bscene, cfg, None, None)}")
        log(f"[{backend}] config_bvh scene {sc.width}x{sc.height} {sc.samples_per_pixel} spp, "
            f"{cfg.tracer.bounce_limit} + {cfg.tracer.mirror_limit} bounces, intersector "
            f"{backend}, {n} frames, {rays} rays/frame: {ms / n:.1f} ms/frame, "
            f"{rays / (ms / n) / 1e3:.3f} Mrays/s{walked}, checksum "
            f"{int(frame.to(torch.int64).sum())}; launches {counts}; eager loop {eager_ms / n:.1f} ms/frame, make_scan_step == eager "
            f"bitwise {same}; {graph_line(graphs)}; {time.perf_counter() - t0:.1f} s | {smi}")
        if (not holds(counts, want, True) or any(counts.get(k) != v for k, v in draws.items())
                or float(frame.float().mean()) <= 1.0 or not same or walks):
            raise SystemExit(f"[{backend}] FAIL: launches {counts} (want {want}), a blank frame, "
                             "a plain walk, or not the eager step's")
        last[backend] = frame.cpu().numpy()
    within, worst = _golden_rule(last["bvh"], last["exact"])
    log(f"[bvh] last frame vs [exact]'s: {within:.6f} within 1 LSB, max diff {worst}")
    if not (within > 0.999 and worst <= 4):
        raise SystemExit("[bvh] FAIL: the bvh and exact runs disagree")

    # [bands-bvh]: config_bvh's scene with the walk as 2 bands on the one
    # card: graph replays against the band body stepped eagerly.
    t0 = time.perf_counter()
    cfg = base.replace(intersector="bvh")
    release()
    init_fn, scan_fn = shard.make_sharded_scan_engine(cfg, [dev] * 2)
    scan_fn(bscene, init_fn(0), [inputs[0], turning])            # bounds, captures
    torch.cuda.synchronize()
    runner = scan_fn.runner_of(bscene)
    graphs = only_graphs(runner)
    replays = graphs.replays
    st0 = init_fn(0)
    kernels.reset_launches()
    (st, frame), ms = timed(lambda: no_sync(lambda: scan_fn(bscene, st0, inputs)))
    counts = dict(kernels.launches)
    replays = graphs.replays - replays
    eager = StepRunner(runner._body, graphs=False)
    est, eager_ms = timed(lambda: run_frames(eager, init_fn(0), inputs))
    eframe = shard.assemble_frame(shard.band_frames(est, shard._band_screen_cfg(cfg, 2)))
    same = states_bitwise(st, est) and torch.equal(frame, eframe)
    want = {"bvh_walk": 2 * n * cfg.tracer.max_segments, "present_halo": 2 * n,
            "shade": 2 * n * cfg.tracer.max_segments, **glue(2 * n)}
    log(f"[bands-bvh] config_bvh scene as 2 bands on the one card, intersector bvh, {n} "
        f"frames: {ms / n:.1f} ms/frame, {replays / n:g} replays a frame, 0 host syncs a frame "
        f"(sync debug mode 'error'); eager band loop {eager_ms / n:.1f} ms/frame, graph == eager "
        f"bitwise {same}; launches {counts}; {graph_line(graphs)}; "
        f"{time.perf_counter() - t0:.1f} s | {smi}")
    if not (same and holds(counts, want, True) and replays == n
            and float(frame.float().mean()) > 1.0):
        raise SystemExit("[bands-bvh] FAIL")
    path_launches["bands-bvh"] = counts["bvh_walk"]

    # [scale-bvh]: config_scale (64x64 maze, 3840x2160) with the walk, its
    # largest tables: an idle and a turning frame replayed from graphs, one
    # walk launch a segment, no host sync, against the eager loop.
    t0 = time.perf_counter()
    cfg = P.NAMED_CONFIGS["scale"]().replace(intersector="bvh")
    release()
    sscene = upload_scene(build_scene(cfg.maze), device=dev)
    frames = [FrameInputs.idle(), turning]
    run = make_scan_step(sscene, cfg)
    run(init_state(cfg, device=dev), frames)                    # first-call costs, captures
    torch.cuda.synchronize()
    st0 = init_state(cfg, seed=0, device=dev)
    kernels.reset_launches()
    (st, frame), ms = timed(lambda: no_sync(lambda: run(st0, frames)))
    counts = dict(kernels.launches)
    graphs = graph_line(only_graphs(run.runner))
    (est, eframe), eager_ms = timed(lambda: make_scan_step_fn(cfg, len(frames))(
        sscene, init_state(cfg, seed=0, device=dev), frames))
    same = states_bitwise(st, est) and torch.equal(frame, eframe)
    sc = cfg.screen
    rays = sc.effective_chunks_per_frame * sc.pixels_per_chunk * sc.samples_per_pixel
    want = {"present": len(frames), "bvh_walk": len(frames) * cfg.tracer.max_segments,
            "shade": len(frames) * cfg.tracer.max_segments, **glue(len(frames))}
    log(f"[scale-bvh] config_scale {sc.width}x{sc.height} {sc.samples_per_pixel} spp, intersector "
        f"bvh, {len(frames)} frames, {rays} rays/frame: "
        f"{ms / len(frames):.1f} ms/frame, {rays / (ms / len(frames)) / 1e3:.3f} Mrays/s, bounds "
        f"{derive_traversal_bounds(sscene, cfg, None, None)}, checksum "
        f"{int(frame.to(torch.int64).sum())}; launches {counts}; eager loop "
        f"{eager_ms / len(frames):.1f} ms/frame, make_scan_step == eager bitwise {same}; "
        f"{graphs}; {time.perf_counter() - t0:.1f} s | {smi}")
    # Two frames light 2/64 of the 4K screen: the frame must not be blank.
    if not (same and holds(counts, want, True) and int(frame.to(torch.int64).sum()) > 0):
        raise SystemExit("[scale-bvh] FAIL")
    path_launches["scale-bvh"] = counts["bvh_walk"]
    del sscene, run, st, st0, frame, est, eframe
    release()

    # The plain walk's host check interval on frame 1's rays (the CPU's path
    # and the kernel's twin): the result is the same for every interval, the
    # time is not.
    cfg = base.replace(intersector="bvh")
    ori, dirs = frame1_rays(cfg, bscene)
    bounds = derive_traversal_bounds(bscene, cfg, None, None)
    tables = intersect.bvh_tables(bscene.prims, bounds[1])
    walk = lambda k: intersect.nearest_hit_bvh(bscene.prims, ori, dirs, cfg.tracer.t_min,
                                               *bounds, check_every=k, tables=tables)
    ref_t, ref_i = walk(1)
    times = []
    for k in CHECK_INTERVALS:
        walk(k)
        (t_k, i_k), ms = timed(lambda: [walk(k) for _ in range(WALK_REPEATS)][-1])
        if not (torch.equal(t_k, ref_t) and torch.equal(i_k, ref_i)):
            raise SystemExit(f"[bvh] FAIL: check_every={k} changes the plain walk's result")
        times.append(f"k={k} {ms / WALK_REPEATS:.2f} ms")
    log(f"[bvh] the plain walk (the CPU's path) on frame 1's {ori.shape[0]} rays, host check "
        f"every k iterations (mean of {WALK_REPEATS}; the default is k="
        f"{intersect.CHECK_EVERY}): {', '.join(times)} (results bitwise equal) | {smi}")

    # [validate]: bench.py --validate's deterministic light, every backend
    # (the port's bench renders the frames) against brute by the reference's
    # hardware rule; only the fused kernel launches a kernel.
    t0 = time.perf_counter()
    kernels.reset_launches()
    frames = bench.validate_frames(dev)
    counts = dict(kernels.launches)
    ref = frames["brute"]
    batches = len(list(frame_row_batches(bench.validate_config(), prng.PRNGKey(0, device=dev),
                                         64, dev)))
    walks = batches * bench.validate_config().replace(intersector="bvh").tracer.max_segments
    ok = (np.isfinite(ref).all() and ref.max() > 0.0
          and holds(counts, {"tracer": batches, "bvh_walk": walks, "shade": 3 * walks,
                             **glue(renders=4 * batches)}, True))
    for backend in ("exact", "bvh", "pallas"):
        d = np.abs(frames[backend] - ref)
        stats = dict(max=float(d.max()), mean=float(d.mean()), p999=float(np.quantile(d, 0.999)),
                     frac_gt_0_05=float((d > 0.05).mean()), frac_nonzero=float((d > 0).mean()))
        good = stats["mean"] < 1e-4 and stats["p999"] < 1e-3 and stats["frac_gt_0_05"] < 1e-3
        ok = ok and good
        log(f"[validate] {backend} vs brute, 16x16 maze 128x96 1 spp jitter 0 bounce_limit 1: "
            f"{json.dumps(stats)} (need mean < 1e-4, p999 < 1e-3, frac_gt_0.05 < 1e-3): "
            f"{'ok' if good else 'FAIL'}")
    log(f"[validate] launches {counts}; {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise SystemExit("[validate] FAIL")

    # [offline]: an orbit of config_bvh's scene through render_path with the
    # fused kernel, written as PNG and GIF and read back.
    t0 = time.perf_counter()
    ocfg = base
    osc = ocfg.screen
    ocam = make_camera(ocfg.camera, osc.width / osc.height, dev)
    cams = campath.orbit_cameras(ocam, (0.0, -3.0, 0.0), 25.0, 0.0, 4)
    kernels.reset_launches()
    path_frames, ms = timed(lambda: campath.render_path(bscene, cams, prng.PRNGKey(0, device=dev),
                                                        ocfg))
    counts = dict(kernels.launches)
    host = path_frames.cpu().numpy()
    n = host.shape[0]
    batches = len(list(frame_row_batches(ocfg, prng.PRNGKey(0, device=dev), 64, dev)))
    with tempfile.TemporaryDirectory() as td:
        png, gif = os.path.join(td, "frame0.png"), os.path.join(td, "orbit.gif")
        imageio.write_png(png, host[0])
        back = imageio.read_png(png)
        imageio.write_gif(gif, host, fps=10)
        with open(gif, "rb") as f:
            gif_head, gif_size = f.read(6), os.path.getsize(gif)
    differ = all(not np.array_equal(host[i], host[i + 1]) for i in range(n - 1))
    log(f"[offline] orbit_cameras x {n} of config_bvh's scene ({osc.width}x{osc.height} "
        f"{osc.samples_per_pixel} spp, fused kernel) through render_path: {ms / n:.1f} ms/frame; "
        f"PNG read back equal {np.array_equal(back, host[0])}, GIF {gif_size} bytes; frames "
        f"differ {differ}; launches {counts}; {time.perf_counter() - t0:.1f} s | {smi}")
    if not (host.shape == (n, osc.height, osc.width, 3) and np.array_equal(back, host[0])
            and gif_head == b"GIF89a" and differ and host.mean() > 1.0
            and holds(counts, {"tracer": n * batches, **glue(renders=n * batches)}, True)):
        raise SystemExit("[offline] FAIL")

    # [resume]: config_interactive, 8 frames, checkpoint, load onto the card,
    # 8 more; against 16 frames straight, bitwise.
    t0 = time.perf_counter()
    icfg = P.NAMED_CONFIGS["interactive"]()
    run = make_scan_step(upload_scene(build_scene(icfg.maze), device=dev), icfg)
    inputs = _script(FrameInputs, JNP_SCRIPTS["resume"])
    half = len(inputs) // 2
    kernels.reset_launches()
    st_a, _ = run(init_state(icfg, device=dev), inputs[:half])
    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "state.npz")
        save_state(ckpt, st_a)
        st_b = load_state(ckpt, icfg, device=dev)
        ckpt_mb = os.path.getsize(ckpt) / 1e6
    loaded = all(torch.equal(getattr(st_a, f), getattr(st_b, f)) for f in EngineState._fields)
    st_c, frame_c = run(st_b, inputs[half:])
    st_d, frame_d = run(init_state(icfg, device=dev), inputs)
    counts = dict(kernels.launches)
    same = (all(torch.equal(getattr(st_c, f), getattr(st_d, f)) for f in EngineState._fields)
            and torch.equal(frame_c, frame_d))
    log(f"[resume] config_interactive {half} frames, save_state ({ckpt_mb:.1f} MB), load_state "
        f"onto the card (equal {loaded}), {len(inputs) - half} more: state and frame == "
        f"{len(inputs)} frames straight, bitwise: {same}; launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    total = 2 * len(inputs)
    if not (loaded and same
            and holds(counts, {"tracer": total, "present": total, **glue(total)}, True)):
        raise SystemExit("[resume] FAIL")
    return {"walk": walk_entries, "shade": shade_entries, "launches": path_launches}


# The drivers' phases run the CLI with these arguments: config_interactive
# at full width (1920x1080, 64 spp); animate on config_bvh's scene.
DRIVER_ARGS = ["--config", "interactive"]
ANIMATE_ARGS = ["--config", "bvh"]
# [play-tty]: the walking frames sent, then 'q'.
TTY_WALK = 30
# [multiplayer]: player 1 walks this many frames while player 0 stands,
# then one more idle frame.
MP_WALK = 20
# One player of [multiplayer]: argv = player id, rendezvous port, walking
# frames, then the CLI's configuration arguments. Runs the script through the
# engine (graph replays on the card), then again from the same initial state
# through the eager route (the exchange, update_avatars, the sphere refresh,
# make_step_fn); then player 1 leaves and player 0's next step must raise.
# Prints one "MP {json}" line.
MP_WORKER = r"""
import json, sys, time
import numpy as np
import torch
pid, port, walk, argv = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4:]
from _torch_tools import eager_multiplayer_step
from mirror_maze_tpu_torch import __main__ as cli, kernels
from mirror_maze_tpu_torch.parallel import initialize_multihost
from mirror_maze_tpu_torch.parallel.multiplayer import (avatar_scene, make_multiplayer_engine,
                                                         make_position_exchange)
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import FrameInputs
from mirror_maze_tpu_torch.runtime.step import derive_traversal_bounds

args = cli.build_parser().parse_args(["play"] + argv)
dev = cli._device(args)
assert initialize_multihost(f"localhost:{port}", 2, pid, timeout_s=120) == 2
cfg, scene, noise = cli._build_world(args)
mdev, init_fn, step_fn = make_multiplayer_engine(cfg, me=pid, scene=scene, device=dev)
exchange = make_position_exchange()
script = [FrameInputs.make(w=pid == 1)] * walk + [FrameInputs.idle()]
step_fn(init_fn(0), FrameInputs.idle())          # first-use costs and the capture, on a scratch state
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
sync()
graphs = next(iter(step_fn.runner.graphs.values()), None)
replays = graphs.replays if graphs else 0
kernels.reset_launches()
st = init_fn(0)
t0 = time.perf_counter()
for inp in script[:-1]:
    st, frame = step_fn(st, inp)
positions = exchange(st.cam_center)
cam = st.cam_center.cpu().tolist()
st, frame = step_fn(st, script[-1])
sync()
ms = (time.perf_counter() - t0) * 1000.0 / len(script)
launches = dict(kernels.launches)
replays = (graphs.replays - replays) if graphs else 0
_, slots = avatar_scene(scene, 2, pid)
eager = eager_multiplayer_step(cfg, mdev, slots, [1 - pid],
                               derive_traversal_bounds(mdev, cfg, None, None))
est = init_fn(0)
t0 = time.perf_counter()
for inp in script:
    est, eframe = eager(est, inp, exchange(est.cam_center))
sync()
eager_ms = (time.perf_counter() - t0) * 1000.0 / len(script)
same = (all(torch.equal(a, b) for a, b in zip(st, est)) and torch.equal(frame, eframe))
frame = frame.cpu().numpy()
out = dict(pid=pid, ms_per_frame=ms, eager_ms_per_frame=eager_ms, launches=launches,
           replays=replays, graph_equals_eager=bool(same), cam=[float(c).hex() for c in cam],
           positions=[[float(c).hex() for c in row] for row in positions.cpu().tolist()],
           spheres=mdev.num_spheres, z=cam[2])
if pid == 1:
    print("MP " + json.dumps(out), flush=True)
    sys.exit(0)                                   # leaves the session
# The same frames of a single-player run: the avatar must show.
_, alone = run_scripted(upload_scene(scene, device=dev), cfg, n_frames=walk + 1)
out["pixels_differing_from_single_player"] = int((alone != frame).any(axis=-1).sum())
try:
    step_fn(st, FrameInputs.idle())
    out["after_leave"] = "stepped"
except RuntimeError as e:
    out["after_leave"] = str(e)
print("MP " + json.dumps(out), flush=True)
"""


def driver_phases(dev, smi: str) -> None:
    """The phases of the drivers: the CLI (``python -m mirror_maze_tpu_torch``),
    terminal play (headless, under a pseudo-terminal, as row bands), the HTTP
    server, two players over gloo, and the offline commands. Each phase prints
    its seconds and the kernel launches counted around it, which must be one
    tracer and one present a frame stepped (none where ``dev`` is the CPU, the
    rehearsal); any failure ends the run with SystemExit."""
    import ast
    import io
    import pty
    import select
    import shutil
    import socket
    import tempfile
    import termios
    import threading
    import urllib.request

    import numpy as np
    import torch

    from mirror_maze_tpu_torch import __main__ as cli
    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.parallel import shard
    from mirror_maze_tpu_torch.render import make_camera, render_full_frame, to_display
    from mirror_maze_tpu_torch.render.pipeline import frame_row_batches
    from mirror_maze_tpu_torch.render.scenebuf import upload_scene
    from mirror_maze_tpu_torch.runtime.loop import InteractiveLoop, run_scripted
    from mirror_maze_tpu_torch.runtime.server import EngineServer
    from mirror_maze_tpu_torch.runtime.state import EngineState, FrameInputs, load_state
    from mirror_maze_tpu_torch.utils import imageio

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    cfg, host_scene, _ = cli._build_world(cli.build_parser().parse_args(["play"] + DRIVER_ARGS))
    sc = cfg.screen
    scene = upload_scene(host_scene, device=dev)
    key0 = prng.PRNGKey(0, device=dev)
    batches = len(list(frame_row_batches(cfg, key0, 64, dev)))
    tmp = tempfile.mkdtemp(prefix="mm_drivers_")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def want(n, renders=0, **kw) -> dict:
        """The launches of n frames stepped: one tracer and one present each
        (or the counts given) and the glue kernels' (``glue``, with
        ``renders`` render_pixels calls), none on the CPU."""
        counts = {**(kw or {"tracer": n, "present": n}), **glue(n, renders)}
        return {k: v for k, v in counts.items() if v} if on_card else {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run_cli(argv):
        """main(argv) in this process, its output captured; (text, launches)."""
        buf = io.StringIO()
        kernels.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        sync()
        if rc != 0:
            raise SystemExit(f"[cli] FAIL: {argv} exited {rc}:\n{buf.getvalue()}")
        return buf.getvalue(), dict(kernels.launches)

    def launches_in(text, label):
        m = re.search(label + r".*?kernel launches (\{[^}]*\})", text)
        return ast.literal_eval(m.group(1)) if m else None

    @contextlib.contextmanager
    def headless():
        saved = sys.stdin
        with open(os.devnull) as f:
            sys.stdin = f
            try:
                yield
            finally:
                sys.stdin = saved

    try:
        # [cli-render]: the real entry point in a subprocess with no --device:
        # bitwise the in-process render_full_frame at the same seed.
        t0 = time.perf_counter()
        out = os.path.join(tmp, "render.png")
        proc = subprocess.run([sys.executable, "-m", "mirror_maze_tpu_torch", "render",
                               *DRIVER_ARGS, *dev_args, "--out", out],
                              cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        t_sub = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"[cli-render] FAIL: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        sub_launches = launches_in(proc.stdout, "rendered")
        cam = make_camera(cfg.camera, sc.width / sc.height, dev)
        kernels.reset_launches()
        t1 = time.perf_counter()
        img = to_display(render_full_frame(scene, cam, key0, cfg)).cpu().numpy()
        t_in = time.perf_counter() - t1
        counts = dict(kernels.launches)
        got = imageio.read_png(out)
        rays = sc.width * sc.height * sc.samples_per_pixel
        line = next(x for x in proc.stdout.splitlines() if x.startswith("rendered"))
        same = got.shape == img.shape and np.array_equal(got, img)
        log(f"[cli-render] python -m mirror_maze_tpu_torch render {' '.join(DRIVER_ARGS)} "
            f"(no --device) in a subprocess: {t_sub:.1f} s with start-up; it printed "
            f"\"{line}\"; PNG read back bitwise the in-process render_full_frame: {same}; in "
            f"process {t_in * 1e3:.1f} ms, {rays / t_in / 1e6:.1f} Mrays/s; launches "
            f"{sub_launches} / {counts} ({batches} row blocks) | {smi}")
        if not (same and img.mean() > 1.0 and sub_launches == counts
                and holds(counts, want(0, renders=batches, tracer=batches), on_card)):
            raise SystemExit("[cli-render] FAIL")

        # [play]: headless play through main(), bitwise run_scripted's idle
        # frames; batched; and through a checkpoint. One warm-up frame a run.
        t0 = time.perf_counter()
        _, want64 = run_scripted(scene, cfg, n_frames=64)
        base = ["play", *DRIVER_ARGS, *dev_args, "--display", "none"]
        ck = os.path.join(tmp, "play.npz")
        runs = {"per-frame": [base + ["--frames", "64"]],
                "batch-frames 8": [base + ["--frames", "64", "--batch-frames", "8"]],
                "save 32 + load 32": [base + ["--frames", "32", "--save-state", ck],
                                      base + ["--frames", "32", "--load-state", ck]]}
        results = []
        with headless():
            for name, argvs in runs.items():
                png = os.path.join(tmp, f"play-{len(results)}.png")
                launched, fps, frames = {}, [], 0
                for argv in argvs:
                    text, counts = run_cli(argv + ["--out", png])
                    for k, v in counts.items():
                        launched[k] = launched.get(k, 0) + v
                    m = re.search(r"session: (\d+) frames, wall ([\d.]+)s \(~([\d.]+) fps", text)
                    frames += int(m.group(1))
                    fps.append(m.group(3))
                same = np.array_equal(imageio.read_png(png), want64)
                ok = same and frames == 64 and holds(launched, want(frames + len(argvs)),
                                                     on_card)
                results.append(ok)
                log(f"[play] {name}: {frames} frames + {len(argvs)} warm-up, final frame "
                    f"bitwise run_scripted's 64 idle frames: {same}; {'/'.join(fps)} fps wall "
                    f"(paced to {sc.fps:g}); launches {launched}")
        log(f"[play] {time.perf_counter() - t0:.1f} s | {smi}")
        if not all(results):
            raise SystemExit("[play] FAIL")

        # [play-tty]: play in a subprocess on a pseudo-terminal: 'w' for
        # TTY_WALK frames, then 'q'.
        t0 = time.perf_counter()
        master, slave = pty.openpty()
        before = termios.tcgetattr(slave)
        chunks, stop = [], threading.Event()

        def drain():
            while not stop.is_set():
                if select.select([master], [], [], 0.05)[0]:
                    try:
                        chunks.append(os.read(master, 1 << 16))
                    except OSError:
                        return

        reader = threading.Thread(target=drain, daemon=True)
        reader.start()
        with open(os.path.join(tmp, "tty.err"), "w+") as err:
            child = subprocess.Popen([sys.executable, "-m", "mirror_maze_tpu_torch", "play",
                                      *DRIVER_ARGS, *dev_args, "--frames", "120"],
                                     stdin=slave, stdout=slave, stderr=err, cwd=tmp, env=env)
            try:
                deadline = time.monotonic() + 300
                while InteractiveLoop.MOUSE_ON.encode() not in b"".join(chunks):
                    if child.poll() is not None or time.monotonic() > deadline:
                        raise SystemExit("[play-tty] FAIL: no cbreak mode")
                    time.sleep(0.02)
                # 'w' a frame time apart, at least TTY_WALK times and until a
                # status line shows the camera moved.
                sent, spawn = 0, f"{cfg.camera.spawn[2]:+.1f})"
                while sent < TTY_WALK or spawn in b"".join(chunks).decode(
                        "utf-8", "replace").rsplit("frame ", 1)[-1][:40]:
                    if child.poll() is not None or time.monotonic() > deadline:
                        raise SystemExit("[play-tty] FAIL: the camera did not move")
                    os.write(master, b"w")
                    sent += 1
                    time.sleep(1.0 / sc.fps)
                os.write(master, b"q")
                rc = child.wait(timeout=120)
            except subprocess.TimeoutExpired:
                child.kill()
                raise SystemExit("[play-tty] FAIL: the session did not end")
            finally:
                time.sleep(0.1)
                stop.set()
                reader.join()
                after = termios.tcgetattr(slave)
                os.close(master)
                os.close(slave)
            err.seek(0)
            err_text = err.read()
        text = b"".join(chunks).decode("utf-8", "replace")
        status = re.findall(r"frame (\d+)  \(([+-][\d.]+), ([+-][\d.]+)\)", text)
        session = re.search(r"session: (\d+) frames.*?\(~([\d.]+) fps.*?kernel launches "
                            r"(\{[^}]*\})", text)
        warm = launches_in(text, "warm-up frame")
        spawn_z = cfg.camera.spawn[2]
        moved = bool(status) and float(status[-1][2]) != round(spawn_z, 1)
        frames = int(session.group(1)) if session else -1
        sess_launches = ast.literal_eval(session.group(3)) if session else None
        log(f"[play-tty] play on a pty, {sent} x 'w' then 'q': exit {rc}, {frames} frames "
            f"at {session.group(2) if session else '?'} fps wall, {len(status)} status lines, "
            f"camera z {spawn_z:+.1f} -> {status[-1][2] if status else '?'}, termios restored "
            f"{after == before}, MOUSE_OFF written {InteractiveLoop.MOUSE_OFF in text}; launches "
            f"warm-up {warm}, session {sess_launches}; {time.perf_counter() - t0:.1f} s")
        if not (rc == 0 and moved and after == before and InteractiveLoop.MOUSE_OFF in text
                and holds(warm, want(1), on_card)
                and holds(sess_launches, want(frames), on_card)):
            raise SystemExit(f"[play-tty] FAIL\n{err_text[-4000:]}")

        # [play-bands]: play with 2 row bands on the one device against the
        # band engine.
        t0 = time.perf_counter()
        init_fn, step_fn = shard.make_sharded_engine(cfg, [dev] * 2)
        st = init_fn(seed=0)
        for _ in range(16):
            st, ref = step_fn(scene, st, FrameInputs.idle())
        ref = ref.cpu().numpy()
        png = os.path.join(tmp, "bands.png")
        with headless():
            text, counts = run_cli(base + ["--sharded-bands", "2", "--frames", "16",
                                           "--out", png])
        same = np.array_equal(imageio.read_png(png), ref)
        log(f"[play-bands] play --sharded-bands 2 --frames 16 (both bands on {dev}): final "
            f"frame bitwise make_sharded_engine's: {same}; launches {counts} (17 frames x 2 "
            f"bands, the warm-up included); {time.perf_counter() - t0:.1f} s")
        if not (same and holds(counts, want(34, tracer=34, present_halo=34), on_card)):
            raise SystemExit("[play-bands] FAIL")

        # [serve]: an EngineServer on port 0 driven over HTTP.
        t0 = time.perf_counter()
        ck = os.path.join(tmp, "serve.npz")
        kernels.reset_launches()
        srv = EngineServer(scene, cfg, port=0, host_scene=host_scene, ckpt_path=ck)
        kept = {}
        do_checkpoint = srv._do_checkpoint

        def keep(eng):
            kept["state"] = EngineState(*(x.clone() for x in eng.state))
            do_checkpoint(eng)

        srv._do_checkpoint = keep
        url = f"http://127.0.0.1:{srv.port}"

        def get(path):
            with urllib.request.urlopen(url + path, timeout=60) as r:
                return r.status, r.headers.get("Content-Type", ""), r.read()

        def post(path, obj):
            req = urllib.request.Request(url + path, data=json.dumps(obj).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read()

        def stats_until(pred, timeout=60.0):
            end = time.monotonic() + timeout
            while time.monotonic() < end:
                s = json.loads(get("/stats")[2])
                if s["error"] is not None:
                    raise SystemExit(f"[serve] FAIL: engine error\n{s['error']}")
                if pred(s):
                    return s
                time.sleep(0.02)
            raise SystemExit(f"[serve] FAIL: {s} after {timeout} s")

        srv.start()
        t_start = time.perf_counter()
        try:
            page = get("/")
            s0 = stats_until(lambda s: s["frame"] > 0)
            status, ctype, body = get("/frame")
            if ctype == "image/png":
                frame_shape = imageio.decode_png(body).shape
            else:
                from PIL import Image

                frame_shape = np.asarray(Image.open(io.BytesIO(body))).shape
            with socket.create_connection(("127.0.0.1", srv.port), 30) as sk:
                sk.settimeout(30.0)
                sk.sendall(b"GET /stream HTTP/1.1\r\nHost: 127.0.0.1\r\n\r\n")
                buf, t_s = b"", time.monotonic()
                while time.monotonic() - t_s < 3.0:
                    buf += sk.recv(1 << 20)
                parts = buf.count(b"--mmxframe")
            map_status, map_ctype, map_body = get("/map")
            map_shape = imageio.decode_png(map_body).shape
            s1 = stats_until(lambda s: True)
            post("/input", {"w": True})
            s2 = stats_until(lambda s: abs(s["cam"][2] - s1["cam"][2]) > 0.5)
            post("/input", {"w": False})
            ck_status, ck_body = post("/ckpt", {})
            info = json.loads(ck_body)
            loaded = load_state(ck, cfg, device=dev)
            ck_same = all(torch.equal(getattr(loaded, f), getattr(kept["state"], f))
                          for f in EngineState._fields)
            s3 = stats_until(lambda s: s["frame"] > s2["frame"] + 30)
        finally:
            srv.stop()
        sync()
        t_session = time.perf_counter() - t_start
        counts = dict(kernels.launches)
        stepped = srv._frames_stepped
        final = srv.stats()
        log(f"[serve] EngineServer on port {srv.port}: / {page[0]}, /frame {status} {ctype} "
            f"{frame_shape}, /stream {parts} parts in 3 s ({parts / 3.0:.1f} fps delivered), "
            f"/map {map_status} {map_shape}, POST /input w moved z {s1['cam'][2]:+.3f} -> "
            f"{s2['cam'][2]:+.3f}, POST /ckpt {ck_status} at frame {info.get('frame')}: "
            f"load_state bitwise the engine's state {ck_same}; engine {s1['fps']:.1f} fps "
            f"while streaming (the last 1 s window), {stepped / t_session:.1f} over the "
            f"{t_session:.1f} s session (the checkpoint's save included); fetch_ms "
            f"{s1['fetch_ms']}, encode_ms {s1['encode_ms']} while streaming (fetched "
            f"{s3['fetched']}, encoded {s3['encoded']} in all); {stepped} frames + 1 warm-up, "
            f"launches {counts}; "
            f"{time.perf_counter() - t0:.1f} s | {smi}")
        if not (page[0] == 200 and s0["frame"] > 0 and status == 200
                and frame_shape == (sc.height, sc.width, 3) and parts >= 3
                and map_status == 200 and map_shape == (320, 320, 3) and ck_status == 200
                and ck_same and info["frame"] == int(kept["state"].frame)
                and final["error"] is None and holds(counts, want(stepped + 1), on_card)):
            raise SystemExit("[serve] FAIL")

        # [multiplayer]: two player processes on the one device over gloo.
        t0 = time.perf_counter()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        mp_env = dict(env, PYTHONPATH=os.path.join(ROOT, "tests") + os.pathsep + env["PYTHONPATH"])
        procs = [subprocess.Popen([sys.executable, "-c", MP_WORKER, str(i), port, str(MP_WALK),
                                   *DRIVER_ARGS, *dev_args],
                                  cwd=tmp, env=mp_env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for i in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise SystemExit("[multiplayer] FAIL: timed out\n" + "\n".join(outs))
        rcs = [p.returncode for p in procs]
        res = []
        for o in outs:
            line = next((x for x in o.splitlines() if x.startswith("MP ")), None)
            res.append(json.loads(line[3:]) if line else None)
        if rcs != [0, 0] or None in res:
            raise SystemExit(f"[multiplayer] FAIL: exits {rcs}\n" + "\n".join(o[-3000:]
                                                                               for o in outs))
        same_pos = res[0]["positions"] == res[1]["positions"] == [r["cam"] for r in res]
        shows = res[0]["pixels_differing_from_single_player"]
        frames = MP_WALK + 1
        left = res[0]["after_leave"]
        log(f"[multiplayer] 2 players over gloo on {dev}, player 1 walks {MP_WALK} frames, "
            f"then 1 idle: graph engine ms/frame {res[0]['ms_per_frame']:.2f} / "
            f"{res[1]['ms_per_frame']:.2f} (player 0 / 1, exchange included), "
            f"{res[0]['replays'] / frames:g} / {res[1]['replays'] / frames:g} replays a frame; "
            f"eager route {res[0]['eager_ms_per_frame']:.2f} / {res[1]['eager_ms_per_frame']:.2f}"
            f" ms/frame; final state and frame bitwise the eager route's: "
            f"{res[0]['graph_equals_eager']} / {res[1]['graph_equals_eager']}; gathered positions "
            f"== each player's cam_center: {same_pos}; player 1 z {res[1]['z']:+.3f}; player 0's "
            f"frame differs from the single-player run's in {shows} pixels; launches "
            f"{res[0]['launches']} / {res[1]['launches']}; after player 1 left, player 0's step: "
            f"{left[:80]!r}; {time.perf_counter() - t0:.1f} s | {smi}")
        if not (same_pos and shows > 0 and res[1]["z"] > cfg.camera.spawn[2]
                and all(holds(r["launches"], want(frames), on_card) for r in res)
                and all(r["graph_equals_eager"] for r in res)
                and all(r["replays"] == (frames if on_card else 0) for r in res)
                and "a peer left the session" in left):
            raise SystemExit("[multiplayer] FAIL")

        # [demo]: the fixed 640-frame script, a PNG per phase.
        t0 = time.perf_counter()
        out = os.path.join(tmp, "demo")
        text, counts = run_cli(["demo", *DRIVER_ARGS, *dev_args, "--out", out])
        pngs = sorted(os.listdir(out))
        imgs = [imageio.read_png(os.path.join(out, n)) for n in pngs]
        good = len(pngs) == 6 and all(i.shape == (sc.height, sc.width, 3) and i.mean() > 1.0
                                      for i in imgs)
        n = len(cli.demo_script(FrameInputs))
        log(f"[demo] {text.strip().splitlines()[-1]}; {len(pngs)} PNGs {pngs[0]} .. {pngs[-1]}, "
            f"non-blank {good}; {time.perf_counter() - t0:.1f} s")
        if not (good and holds(counts, want(n), on_card)):
            raise SystemExit("[demo] FAIL")

        # [animate]: the default spin path on config_bvh's scene, as a GIF.
        t0 = time.perf_counter()
        out = os.path.join(tmp, "anim.gif")
        seen = {}
        write_gif = imageio.write_gif

        def keep_frames(path, frames, fps=20, loop=0):
            seen["frames"] = np.asarray(frames)
            write_gif(path, frames, fps=fps, loop=loop)

        imageio.write_gif = keep_frames
        try:
            text, counts = run_cli(["animate", *ANIMATE_ARGS, *dev_args, "--out", out])
        finally:
            imageio.write_gif = write_gif
        acfg, _, _ = cli._build_world(cli.build_parser().parse_args(["animate"] + ANIMATE_ARGS))
        fr = seen["frames"]
        a_batches = len(list(frame_row_batches(acfg, key0, 64, dev)))
        with open(out, "rb") as f:
            head = f.read(10)
        good = (fr.shape == (48, acfg.screen.height, acfg.screen.width, 3)
                and all(f.mean() > 1.0 for f in fr) and head[:6] == b"GIF89a"
                and int.from_bytes(head[6:8], "little") == acfg.screen.width)
        log(f"[animate] {text.strip().splitlines()[-1]}; frames {fr.shape} non-blank, GIF "
            f"{os.path.getsize(out)} bytes: {good}; {time.perf_counter() - t0:.1f} s")
        if not (good and holds(counts, want(0, renders=48 * a_batches, tracer=48 * a_batches),
                               on_card)):
            raise SystemExit("[animate] FAIL")

        # [multicam]: 4 cameras fanned around the spawn, a 2x2 grid.
        t0 = time.perf_counter()
        out = os.path.join(tmp, "multicam.png")
        text, counts = run_cli(["multicam", *DRIVER_ARGS, *dev_args, "--cameras", "4",
                                "--out", out])
        grid = imageio.read_png(out)
        h, w = sc.height, sc.width
        good = grid.shape == (2 * h, 2 * w, 3) and all(
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w].mean() > 1.0
            for r in range(2) for c in range(2))
        log(f"[multicam] {text.strip().splitlines()[-1]}; grid {grid.shape} with 4 non-blank "
            f"views: {good}; {time.perf_counter() - t0:.1f} s")
        # One launch a camera and row tile: the renderer traces a tile's rows
        # at once (parallel/shard.py make_sharded_renderer).
        if not (good and holds(counts, want(0, renders=4, tracer=4), on_card)):
            raise SystemExit("[multicam] FAIL")

        # [minimap]: host only, no launch.
        t0 = time.perf_counter()
        out = os.path.join(tmp, "minimap.png")
        text, counts = run_cli(["minimap", *DRIVER_ARGS, "--out", out])
        mm = imageio.read_png(out)
        good = mm.shape == (512, 512, 3) and len(np.unique(mm.reshape(-1, 3), axis=0)) > 3
        log(f"[minimap] {text.strip()}; non-blank {good}; launches {counts}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not (good and counts == {}):
            raise SystemExit("[minimap] FAIL")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The repository's own entry points on the port: the bench at its defaults
# (config_interactive's operating point, 60 frames x 3 timed calls after one
# warm-up call), the same as 2 row bands, the card soak and the examples.
BENCH_ARGS: list = []
BENCH_BANDS_ARGS = ["--sharded-bands", "2", "--frames", "8", "--launches", "1"]
BENCH_BVH_ARGS = ["--intersector", "bvh"]
# [bench-bvh]: the frames of the bench's configuration run in process as
# graph replays and as the eager loop.
BENCH_BVH_FRAMES = 4
SOAK_SCENES = 40
EXAMPLE_ARGS = ["--intersector", "pallas", "--size", "256", "--spp", "64"]
MP_DEMO_ARGS = ["--players", "3", "--frames", "24"]


def entry_phases(dev, smi: str) -> dict:
    """The phases of the repository's own entry points on the port: the
    bench (``python -m mirror_maze_tpu_torch.bench``), its ``--validate``,
    ``--sharded-bands`` and ``--intersector bvh``, the kernel exactness soak
    and the three examples. The bench and the examples run in subprocesses
    with no ``--device`` (the card; ``--device cpu`` where ``dev`` is the
    CPU, the rehearsal). Each phase prints its seconds; any failure ends the
    run with SystemExit. Returns ``[bench-bvh]``'s launches: the bench's
    normal and erf_inv draws and shade launches, and the in-process eager
    loop's walks at a frame's first segment and at the others (and of those
    the walks given a live-id list)."""
    import ast
    import shutil
    import tempfile

    import torch

    from mirror_maze_tpu_torch import bench, kernels
    from mirror_maze_tpu_torch.examples import cornell_box, mesh_gallery, multiplayer_demo
    from mirror_maze_tpu_torch.parallel.shard import make_sharded_scan_engine
    from mirror_maze_tpu_torch.runtime.state import FrameInputs, init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_scan_step_fn, repeat_input
    from mirror_maze_tpu_torch.tools import soak_kernel
    from mirror_maze_tpu_torch.utils import imageio
    from _torch_tools import gif_frame_count

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    tmp = tempfile.mkdtemp(prefix="mm_entry_")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_all = time.perf_counter()

    def want(frames=0, renders=0, **counts) -> dict:
        """The launches given, with the glue kernels' of ``frames`` frames
        stepped and ``renders`` render_pixels calls; none on the CPU."""
        counts = {**counts, **glue(frames, renders)}
        return {k: v for k, v in counts.items() if v} if on_card else {}

    def run(tag, module, argv, timeout=600):
        """``python -m module argv`` in a subprocess: (stdout, stderr)."""
        proc = subprocess.run([sys.executable, "-m", module, *argv, *dev_args], cwd=tmp,
                              env=env, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise SystemExit(f"[{tag}] FAIL: {module} {' '.join(argv)} exited "
                             f"{proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        return proc.stdout, proc.stderr

    def bench_run(tag, argv):
        """The bench's JSON line and the launches it printed to stderr."""
        out, err = run(tag, "mirror_maze_tpu_torch.bench", argv)
        m = re.search(r"kernel launches (\{[^}]*\})", err)
        return json.loads(out.strip().splitlines()[-1]), ast.literal_eval(m.group(1))

    try:
        # [bench]: the bench at its defaults; its checksum against the same
        # configuration stepped through as many idle frames in this process.
        t0 = time.perf_counter()
        res, sub = bench_run("bench", BENCH_ARGS)
        args = bench.build_parser().parse_args(BENCH_ARGS + dev_args)
        n = args.frames * (1 + args.launches)
        cfg, _, scene = bench.build_bench_setup(args)
        kernels.reset_launches()
        _, frame = make_scan_step(scene, cfg)(init_state(cfg, seed=0, device=dev),
                                               repeat_input(FrameInputs.idle(), n))
        checksum = float(frame.sum())
        counts = dict(kernels.launches)
        del scene, frame
        log(f"[bench] python -m mirror_maze_tpu_torch.bench {' '.join(BENCH_ARGS)} "
            f"(no --device) in a subprocess: {res['value']} Mrays/s, frame_ms "
            f"{res['frame_ms']}, launch_ms {res['launch_ms']}, setup_s {res['setup_s']:.3f}, "
            f"compile_s {res['compile_s']} (B = {cfg.tracer.block_rows * 128}, "
            f"{res['rays_per_frame']} rays a frame, {res['kernel_planes']} kernel planes); "
            f"backend {res['backend']}, device {res['device']!r}; frame_checksum "
            f"{res['frame_checksum']} against {checksum} for {n} idle frames in process; "
            f"launches {sub} / {counts}; {time.perf_counter() - t0:.1f} s | {smi}")
        if not (res["backend"] == dev.type and res["frame_checksum"] == round(checksum, 1)
                and holds(sub, want(n, tracer=n, present=n), on_card)
                and holds(counts, want(n, tracer=n, present=n), on_card)
                and len(res["launch_ms"]) == args.launches):
            raise SystemExit("[bench] FAIL")

        # [bench-validate]: the cross-backend check under the CPU gates.
        t0 = time.perf_counter()
        out, _ = run("bench-validate", "mirror_maze_tpu_torch.bench", ["--validate"])
        res = json.loads(out.strip().splitlines()[-1])
        log(f"[bench-validate] --validate on {res['device']!r}: ok {res['ok']}; "
            + "; ".join(f"{b} {json.dumps(res[b])}" for b in ("pallas", "bvh", "exact"))
            + f" (bvh and exact need max 0, pallas frac_nonzero and mean < 1e-3); "
            f"{time.perf_counter() - t0:.1f} s")
        if not (res["ok"] is True and res["backend"] == dev.type):
            raise SystemExit("[bench-validate] FAIL")

        # [bench-bands]: 2 row bands on the one device against the band
        # engine stepped in this process.
        t0 = time.perf_counter()
        res, sub = bench_run("bench-bands", BENCH_ARGS + BENCH_BANDS_ARGS)
        args = bench.build_parser().parse_args(BENCH_ARGS + BENCH_BANDS_ARGS + dev_args)
        n, bands = args.frames * (1 + args.launches), args.sharded_bands
        cfg, _, scene = bench.build_bench_setup(args)
        init_fn, scan_fn = make_sharded_scan_engine(cfg, devices=[dev] * bands)
        _, frame = scan_fn(scene, init_fn(seed=0), repeat_input(FrameInputs.idle(), n))
        checksum = float(frame.sum())
        del scene, frame
        log(f"[bench-bands] --sharded-bands {bands} (every band on {dev}): {res['value']} "
            f"Mrays/s, frame_ms {res['frame_ms']}; frame_checksum {res['frame_checksum']} "
            f"against the band engine's {checksum} over {n} frames; launches {sub}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not (res["frame_checksum"] == round(checksum, 1) and res["sharded_bands"] == bands
                and holds(sub, want(bands * n, tracer=bands * n, present_halo=bands * n),
                          on_card)):
            raise SystemExit("[bench-bands] FAIL")

        # [bench-bvh]: the bench with the BVH walk at its defaults
        # (config_interactive's point); in process, a few frames of the same
        # configuration as graph replays (no host sync) and as the eager
        # loop, bitwise.
        t0 = time.perf_counter()
        res, sub = bench_run("bench-bvh", BENCH_ARGS + BENCH_BVH_ARGS)
        args = bench.build_parser().parse_args(BENCH_ARGS + BENCH_BVH_ARGS + dev_args)
        n = args.frames * (1 + args.launches)
        cfg, _, scene = bench.build_bench_setup(args)
        segs, k = cfg.tracer.max_segments, BENCH_BVH_FRAMES
        frames = [FrameInputs.idle()] * (k - 2) + [FrameInputs.make(w=True, mouse_dx=-27.0)] * 2
        scan = make_scan_step(scene, cfg)
        scan(init_state(cfg, seed=0, device=dev), [frames[0], frames[-1]])   # the captures
        st0 = init_state(cfg, seed=0, device=dev)
        graphs = next(iter(scan.runner.graphs.values()), None)
        replays = graphs.replays if graphs else 0
        kernels.reset_launches()
        t1 = time.perf_counter()
        st, frame = (no_sync if on_card else (lambda f: f()))(lambda: scan(st0, frames))
        checksum = int(frame.to(torch.int64).sum())
        graph_ms = (time.perf_counter() - t1) * 1e3 / k
        counts = dict(kernels.launches)
        replays = (graphs.replays - replays) if graphs else 0
        # The eager loop counts its walks by segment: the camera rays' at a
        # frame's first (bvh_walk@interactive), the bounced rays' at the
        # others (bvh_walk@bounce).
        t1 = time.perf_counter()
        with walks_by_segment(collections.Counter()) as walks:
            est, eframe = make_scan_step_fn(cfg, k)(scene, init_state(cfg, seed=0, device=dev),
                                                     frames)
        eager_ms = (time.perf_counter() - t1) * 1e3 / k
        same = states_bitwise(st, est) and torch.equal(frame, eframe)
        del scene, scan, st, est, frame, eframe
        if on_card:
            release()
        log(f"[bench-bvh] python -m mirror_maze_tpu_torch.bench {' '.join(BENCH_BVH_ARGS)} (no "
            f"--device) in a subprocess: {res['value']} Mrays/s, frame_ms {res['frame_ms']}, "
            f"launch_ms {res['launch_ms']}, frame_checksum {res['frame_checksum']} "
            f"({res['rays_per_frame']} rays a frame, {n} frames); launches {sub}; in process "
            f"{k} frames (idle, then walking and turning): graph {graph_ms:.2f} ms/frame (host "
            f"clock, synchronized), {replays / k:g} replays a frame, 0 host syncs (sync debug "
            f"mode 'error'), launches {counts}; eager loop {eager_ms:.2f} ms/frame, walk "
            f"launches at a frame's first segment {walks['first']}, at the others "
            f"{walks['later']} ({walks['listed']} of them on the live-id list); graph == eager "
            f"bitwise {same}; checksum {checksum}; "
            f"{time.perf_counter() - t0:.1f} s | {smi}")
        if not (res["backend"] == dev.type and same and len(res["launch_ms"]) == args.launches
                and holds(sub, want(n, present=n, bvh_walk=n * segs, shade=n * segs), on_card)
                and holds(counts, want(k, present=k, bvh_walk=k * segs, shade=k * segs),
                          on_card)
                and sub.get("threefry_normal", 0) == (n if on_card else 0)
                and sub.get("threefry_normal_listed", 0) == (n * (segs - 1) if on_card else 0)
                and counts.get("threefry_normal", 0) == (k if on_card else 0)
                and counts.get("threefry_normal_listed", 0) == (k * (segs - 1) if on_card else 0)
                and replays == (k if on_card else 0)
                and (walks["first"], walks["later"], walks["listed"]) == (
                    (k, k * (segs - 1), k * (segs - 1)) if on_card else (0, 0, 0))):
            raise SystemExit("[bench-bvh] FAIL")
        bench_bvh_launches = dict(
            {name: sub.get(name, 0) for name in ("threefry_normal", "threefry_normal_listed",
                                                 "threefry_erf_inv", "shade")},
            walk_first=walks["first"], walk_later=walks["later"], walk_listed=walks["listed"])

        # [soak]: the random soups, the kernel bitwise its plain version under
        # two grids and within the jnp tracer's gate.
        t0 = time.perf_counter()
        kernels.reset_launches()
        recs = soak_kernel.run_soak(SOAK_SCENES, dev, log=lambda line: log(f"[soak] {line}"))
        counts = dict(kernels.launches)
        fails = [r["seed"] for r in recs if not r["ok"]]
        resident = sum(bool(r["geometry"].get("resident")) for r in recs)
        walked = [r["walked_tiles"] for r in recs]
        grids = sorted({k for r in recs for k in r["bitwise"]})
        n_rays = soak_kernel.CARD_RAYS if on_card else soak_kernel.CPU_RAYS
        log(f"[soak] {len(recs)} scenes of {n_rays} rays: failures {fails}; {resident} resident in shared memory, "
            f"{len(recs) - resident} not; {sum(w > 0 for w in walked)} scenes walk tiles "
            f"({sum(walked)} walked tiles in all, at most {max(walked)}); launches compared: "
            f"{grids}; min agreement with the jnp tracer "
            f"{min(r['agree'] for r in recs):.4f}; launches {counts}; "
            f"{time.perf_counter() - t0:.1f} s | {smi}")
        # One launch a scene and grid, of the textured library where the scene
        # is textured; the jnp tracer's reference light one shade launch a
        # segment.
        expected = sum(len(r["bitwise"]) for r in recs) if on_card else 0
        shades = sum(r["segments"] for r in recs) if on_card else 0
        fused = {k: v for k, v in others(counts).items() if k != "shade"}
        if (fails or len(recs) != SOAK_SCENES or sum(fused.values()) != expected
                or set(fused) - {"tracer", "tracer_tex"} or counts.get("shade", 0) != shades):
            raise SystemExit("[soak] FAIL")

        # [examples]: the Cornell box and the mesh gallery in subprocesses,
        # their PNGs bitwise the in-process render; three players over gloo.
        t0 = time.perf_counter()
        size = int(EXAMPLE_ARGS[EXAMPLE_ARGS.index("--size") + 1])
        spp = int(EXAMPLE_ARGS[EXAMPLE_ARGS.index("--spp") + 1])
        for name, mod, scene in (
                ("cornell_box", cornell_box, cornell_box.build_cornell_box()),
                ("mesh_gallery", mesh_gallery, mesh_gallery.build_mesh_gallery())):
            t1 = time.perf_counter()
            png, npz = os.path.join(tmp, name + ".png"), os.path.join(tmp, name + ".npz")
            run("examples", f"mirror_maze_tpu_torch.examples.{name}",
                EXAMPLE_ARGS + ["--out", png, "--save-scene", npz])
            t_sub = time.perf_counter() - t1
            kernels.reset_launches()
            t1 = time.perf_counter()
            img = mod.render_scene(scene, cornell_box.render_config(size, spp, "pallas"), dev)
            t_in = time.perf_counter() - t1
            counts = dict(kernels.launches)
            got = imageio.read_png(png)
            same = got.shape == img.shape and bool((got == img).all())
            log(f"[examples] {name} {' '.join(EXAMPLE_ARGS)} in a subprocess {t_sub:.1f} s "
                f"with start-up; PNG bitwise the in-process render_full_frame ({t_in:.2f} s): "
                f"{same}; launches {counts}")
            if not (same and img.mean() > 1.0
                    and holds(counts, want(renders=-(-size // 64), tracer=-(-size // 64)),
                              on_card)):
                raise SystemExit("[examples] FAIL")
        t1 = time.perf_counter()
        gif = os.path.join(tmp, "mp.gif")
        out, _ = run("examples", "mirror_maze_tpu_torch.examples.multiplayer_demo",
                     MP_DEMO_ARGS + ["--out", gif], timeout=300)
        players = int(MP_DEMO_ARGS[MP_DEMO_ARGS.index("--players") + 1])
        frames = int(MP_DEMO_ARGS[MP_DEMO_ARGS.index("--frames") + 1])
        z = {int(p): float.fromhex(json.loads(pos)[2]) for p, pos in
             re.findall(r"player (\d+) done at z=\S+ (\[.*\])", out)}
        spawn = {p: multiplayer_demo.player_config(p).camera.spawn[2] for p in range(players)}
        n_gif = gif_frame_count(gif)
        log(f"[examples] multiplayer_demo {' '.join(MP_DEMO_ARGS)}: {players} processes over "
            f"gloo on {dev}, final z {z} from spawn z {spawn}; GIF of {n_gif} frames; "
            f"{time.perf_counter() - t1:.1f} s")
        if not (sorted(z) == list(range(players)) and z[0] == spawn[0]
                and all(z[p] > spawn[p] for p in range(1, players))
                and n_gif == frames // multiplayer_demo.GIF_EVERY):
            raise SystemExit("[examples] FAIL")
        log(f"[examples] {time.perf_counter() - t0:.1f} s; the entry points' phases "
            f"{time.perf_counter() - t_all:.1f} s in all")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"bench-bvh": bench_bvh_launches}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


KERNEL_PHASES = ("bvh-kernel", "threefry", "frame-glue")


def kernel_rows(port: str, only=KERNEL_PHASES) -> int:
    """``--kernels-of DIR``: the ``[bvh-kernel]`` and ``[threefry]`` phases
    alone on the port in ``port`` (with this checkout's phases and test
    helpers), and ``[frame-glue]`` where that port has the glue kernels (of
    those, the phases in ``only``), then one JSON line of their rows (ms,
    plain ms, bound, and frame_setup's launch floor) and the card's line."""
    import torch

    import mirror_maze_tpu_torch as P
    from mirror_maze_tpu_torch import kernels

    if os.path.dirname(os.path.abspath(P.__file__)) != os.path.join(port,
                                                                     "mirror_maze_tpu_torch"):
        raise SystemExit(f"chip_smoke: the port imported is not {port}'s")
    smi = card_line()
    log(smi)
    glue = "frame_setup" in kernels.LIBRARIES and "frame-glue" in only
    kernels.build(("bvh_walk", "threefry") + (("frame_setup", "camera_rays", "resolve")
                                              if glue else ()), verbose=True)
    dev = torch.device("cuda")
    rows = bvh_kernel_phase(dev, smi) if "bvh-kernel" in only else {}
    if "threefry" in only:
        from mirror_maze_tpu_torch.ops import prng

        # A port before the listed draw has no rows= and no live rows.
        rows.update(threefry_phase(dev, smi, P.NAMED_CONFIGS["interactive"](),
                                   listed="rows" in inspect.signature(prng.normal).parameters))
    if glue:
        rows.update(frame_glue_phase(dev, smi))
    print(json.dumps({"port": port, "rows": {
        row: {k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "floor_ms") if k in e}
        for row, e in rows.items()}}))
    print(smi)
    return 0


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-of", metavar="DIR",
                    help="run only [bvh-kernel], [threefry] and [frame-glue] on the port in "
                         "DIR (a git archive of another commit unpacked there is timed by the "
                         "same method) and print their rows")
    ap.add_argument("--only", action="append", choices=KERNEL_PHASES,
                    help="with --kernels-of: run only this phase (may be repeated)")
    args = ap.parse_args()
    # The smoke drives one card: show it only the first one, so that the
    # device count it reports is the count it used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0"
    os.environ["CUDA_VISIBLE_DEVICES"] = visible

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    if args.kernels_of:
        sys.path.insert(0, os.path.abspath(args.kernels_of))
        return kernel_rows(os.path.abspath(args.kernels_of), args.only or KERNEL_PHASES)
    try:
        import mirror_maze_tpu_torch as P
        from _torch_tools import (
            CORNELL_GLASS_CENTRE,
            GALLERY_SPAWN,
            checker_floor,
            cornell_scene,
            gallery_config,
            golden_config,
            golden_script,
            mesh_gallery_scene,
            soup_arrays,
            textured_cornell,
        )
        from time_present import HBM_BYTES_PER_S, time_ms, time_present
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused, trace_paths_plain
    from mirror_maze_tpu_torch.render.camera import make_camera
    from mirror_maze_tpu_torch.render.pipeline import (
        frame_rays,
        frame_row_batches,
        render_full_frame,
    )
    from mirror_maze_tpu_torch.render.present import present, present_plain
    from mirror_maze_tpu_torch.parallel import shard
    from mirror_maze_tpu_torch.render.scenebuf import make_sphere_refresh, upload_scene
    from mirror_maze_tpu_torch.render.scheduler import (
        chunk_origin_xy,
        chunk_pixels,
        sort_window_morton,
        take_chunks,
    )
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.runtime.loop import run_scripted
    from mirror_maze_tpu_torch.runtime.state import (
        FrameInputs,
        init_state,
        load_state,
        save_state,
    )
    from mirror_maze_tpu_torch.runtime.graph import StepRunner
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_scan_step_fn, run_frames
    from mirror_maze_tpu_torch.scene import build_scene
    from mirror_maze_tpu_torch.scene.builder import Scene
    from mirror_maze_tpu_torch.utils.profiling import (
        sass_loops,
        tracer_segment_histogram,
        warp_lane_share,
    )

    # Nothing in the package enables TF32: the brute backend's products and
    # the plain versions' comparison paths run in full float32.
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        print("chip_smoke: TF32 matmuls are enabled", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False

    # 1. Device.
    smi = card_line()
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[device] {name}, {torch.cuda.device_count()} visible | torch {torch.__version__} "
        f"| cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    # 2. Build.
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    log(f"[build] {', '.join(kernels.LIBRARIES)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    # What the resident quads-only kernel's scan loops compile to: per loop,
    # its instructions beside its plane records (one MUFU.RCP each).
    text = kernels.sass("tracer")
    if text is None:
        log("[sass] no cuobjdump in this toolkit")
    else:
        for lp in sass_loops(text, SASS_KERNEL):
            log(f"[sass] {SASS_KERNEL} loop {lp['start']:#06x}-{lp['end']:#06x}: "
                f"{lp['insts']} instructions for {lp['rcp']} records "
                f"({lp['insts'] / lp['rcp']:.1f} a record; {lp['lds'] / lp['rcp']:.1f} shared "
                f"loads, {lp['f32'] / lp['rcp']:.1f} f32 instructions; 16 f32 operations and "
                f"16 per tested edge counted in the bound)")
        # The axis route's pass-1 loops (one 16-byte entry a record in
        # modes 1 and 2, no reciprocal).
        for lp in sass_loops(text, SASS_AXIS_KERNEL, marker="LDS.128"):
            if lp["rcp"] == 0:
                log(f"[sass] {SASS_AXIS_KERNEL} pass-1 loop {lp['start']:#06x}-"
                    f"{lp['end']:#06x}: {lp['insts']} instructions for {lp['records']} "
                    f"entries ({lp['insts'] / lp['records']:.1f} an entry; "
                    f"{lp['f32'] / lp['records']:.1f} f32 instructions)")

    import dataclasses

    def with_glass(cfg, fresnel=True):
        return dataclasses.replace(
            cfg, maze=dataclasses.replace(cfg.maze, glass_prob=0.5),
            tracer=dataclasses.replace(cfg.tracer, fresnel=fresnel))

    configs = {"main": P.NAMED_CONFIGS["interactive"](), "scale": P.NAMED_CONFIGS["scale"](),
               "fuzzy": P.NAMED_CONFIGS["fuzzy"]()}
    configs["glass"] = with_glass(configs["main"])
    configs["glass-scale"] = with_glass(configs["scale"])
    scenes = {k: upload_scene(build_scene(c.maze), device=dev) for k, c in configs.items()}
    configs["glass-no-fresnel"] = with_glass(configs["main"], fresnel=False)
    scenes["glass-no-fresnel"] = scenes["glass"]
    configs["sky"] = dataclasses.replace(configs["main"], tracer=dataclasses.replace(
        configs["main"].tracer, sky_strength=0.7))
    scenes["sky"] = scenes["main"]
    entries = {}

    # 3. Present kernel vs its plain version: bitwise, on a random
    # chunk-major screen of the path's size.
    def check_present(tag, row, sc):
        gen = torch.Generator(device=dev).manual_seed(0)
        screen = torch.rand((sc.total_chunks, sc.pixels_per_chunk * 3), generator=gen,
                            device=dev) * 1.2 - 0.1
        err = 0.0
        for quantize in (True, False):
            got = present(screen, sc, quantize)
            want = present_plain(screen, sc, quantize)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                bad = int((got != want).sum())
                raise SystemExit(f"[{tag}] FAIL quantize={quantize}: {bad} floats differ")
            log(f"[{tag}] kernel == plain bitwise, quantize={quantize}, "
                f"{sc.width}x{sc.height}, shape {tuple(screen.shape)}")
        t = time_present(lambda: present(screen, sc, True), 2 * screen.numel() * 4)
        entries[row] = dict(
            kernel="present", lib="present", max_abs_err=err, ms=t["ms"],
            plain_ms=time_ms(lambda: present_plain(screen, sc, True), 5),
            bound_ms=max(t["bound_ms"], 10 * screen.numel() / FP32_OPS_PER_S * 1e3),
            bound_by="bytes",
        )
        log(f"[{tag}] kernel {t['ms']:.4f} ms/launch with the L2 emptied before each launch "
            f"(the row), {t['warm']:.4f} back to back (a CUDA graph's replay; "
            f"{screen.numel() * 4 / 1e6:.1f} MB screen, 50 MB L2), "
            f"{entries[row]['bound_ms'] / t['ms']:.1%} of the bytes bound "
            f"{entries[row]['bound_ms']:.4f} ms | {smi}")

    check_present("present", "present", configs["main"].screen)
    check_present("present-4k", "present@4k", configs["scale"].screen)

    # The halo variant: a screen cut into row bands, each presented with its
    # neighbours' rows; put together, bitwise the no-halo kernel on the whole
    # screen, and band by band the plain version with halos.
    def check_present_halo(tag, row, sc, n_bands):
        gen = torch.Generator(device=dev).manual_seed(1)
        screen = torch.rand((sc.total_chunks, sc.pixels_per_chunk * 3), generator=gen,
                            device=dev) * 1.2 - 0.1
        band = dataclasses.replace(sc, height=sc.height // n_bands)
        bands = list(screen.chunk(n_bands))
        tops, bots = shard._exchange_halo_rows(bands, band)
        err = 0.0
        for quantize in (True, False):
            got = [present(b, band, quantize, t, u) for b, t, u in zip(bands, tops, bots)]
            whole = present(screen, sc, quantize)
            torch.cuda.synchronize()
            if not torch.equal(torch.cat(got).view(torch.int32), whole.view(torch.int32)):
                raise SystemExit(f"[{tag}] FAIL quantize={quantize}: the bands put together "
                                 "are not the whole screen's present")
            for g, b, t, u in zip(got, bands, tops, bots):
                want = present_plain(b, band, quantize, t, u)
                err = max(err, float((g - want).abs().max()))
                if not torch.equal(g.view(torch.int32), want.view(torch.int32)):
                    raise SystemExit(f"[{tag}] FAIL quantize={quantize}: a band differs from "
                                     "its plain version")
            if torch.equal(got[-1], present(bands[-1], band, quantize)):
                raise SystemExit(f"[{tag}] FAIL: the halo rows change nothing")
            log(f"[{tag}] {n_bands} bands of {sc.width}x{band.height}: halo kernel per band == "
                f"plain bitwise, bands concatenated == no-halo kernel on the whole screen "
                f"bitwise, quantize={quantize}")
        b0, t0_, u0 = bands[1], tops[1], bots[1]
        t = time_present(lambda: present(b0, band, True, t0_, u0),
                         (2 * b0.numel() + t0_.numel() + u0.numel()) * 4)
        bound = max(t["bound_ms"], 10 * b0.numel() / FP32_OPS_PER_S * 1e3)
        entries[row] = dict(
            kernel="present", lib="present_halo", max_abs_err=err, ms=t["ms"],
            plain_ms=time_ms(lambda: present_plain(b0, band, True, t0_, u0), 5),
            bound_ms=bound, bound_by="bytes",
        )
        none = time_ms(lambda: present(b0, band, True), 50, graph=True)
        one_by_one = time_ms(lambda: present(b0, band, True, t0_, u0), 50)
        log(f"[{tag}] per band {t['ms']:.4f} ms/launch with halos and the L2 emptied before "
            f"each launch (the row); back to back from a CUDA graph {t['warm']:.4f} with halos, "
            f"{none:.4f} without; launched one by one from the host {one_by_one:.4f}; "
            f"{bound / t['ms']:.1%} of the bytes bound {bound:.4f} ms, plain version "
            f"{entries[row]['plain_ms']:.3f} ms | {smi}")

    check_present_halo("present-halo", "present-halo", configs["main"].screen, 2)
    check_present_halo("present-halo-4k", "present-halo@4k", configs["scale"].screen, 4)

    # 3b. The threefry kernel vs its plain version: bitwise in every output,
    # on the main path's jitter draw and the jnp tracer's draws.
    entries.update(threefry_phase(dev, smi, configs["main"]))
    entries.update(frame_glue_phase(dev, smi))
    big_launches = big_phases(dev, smi)

    # 4. Tracer kernel vs its plain version on frame 1's rays of each path.
    # The kernel traces the whole wavefront. The plain version traces the
    # whole wavefront too, or ``programs`` whole blocks of B rays spread
    # evenly over it, each ray keeping its place in the wavefront (its
    # seed); its counts are then scaled to the wavefront for the bound.
    def compare_tracer(tag, row, scene, tc, rays, anchor, programs=None):
        ori, dirs, seed, seed_row = rays
        block = tc.block_rows
        n_rays, b = ori.shape[0], block * 128
        kernel = lambda row=seed_row, geometry=None: trace_paths_fused(
            scene, ori, dirs, seed, tc, block, anchor=anchor, seed_row=row, geometry=geometry)
        geo = {}
        got = kernel(geometry=geo)
        lib = "tracer_tex" if scene.textured else "tracer"
        if programs is None:
            pick = torch.arange(n_rays, device=dev)
        else:
            n_prog = n_rays // b
            first = torch.arange(programs, device=dev) * (n_prog // programs)
            pick = (first[:, None] * b + torch.arange(b, device=dev)).reshape(-1)
        sub_row = None if seed_row is None else seed_row[pick]
        plain = lambda stats=None, skip=True: trace_paths_plain(
            scene, ori[pick], dirs[pick], seed, tc, block, anchor=anchor,
            seed_row=sub_row, ray_ids=pick, stats=stats, skip=skip)
        stats = {}
        want = plain(stats)
        torch.cuda.synchronize()
        sub = got[pick]
        tiles = [g[2] for g in scene.group_meta]
        n_walk = sum(n for n in tiles if n > 1)
        # The per-ray tile skip against no skip at all: they differ only on
        # rays that leave the closed world (render/fused_tracer.py).
        unskipped = 1.0
        if n_walk:
            unskipped = float((sub == plain(skip=False)).all(dim=1).float().mean())
        close = torch.isclose(sub, want, rtol=1e-5, atol=1e-6).all(dim=1)
        frac = float(close.float().mean())
        exact = float((sub == want).all(dim=1).float().mean())
        mean_rel = (abs(float(sub.mean()) - float(want.mean()))
                    / max(abs(float(want.mean())), 1e-12))
        err = float((sub - want).abs().max())
        ok = torch.isfinite(got).all() and frac >= 0.99 and mean_rel <= 1e-3
        segs = stats["ray_segments"]
        log(f"[{tag}] {n_rays} rays, {scene.num_planes} planes and {scene.num_spheres} spheres "
            f"(modes 0-7: {scene.mode_counts}) in tiles {tiles} of modes "
            f"{[g[0] for g in scene.group_meta]}, fresnel {tc.fresnel}, B={b}, plain version on "
            f"{pick.numel()} rays"
            f"{'' if programs is None else f' ({programs} programs of B)'}: {frac:.6f} of rays "
            f"within rtol 1e-5 (need >= 0.99), {exact:.6f} bitwise, mean light rel diff "
            f"{mean_rel:.2e} (need <= 1e-3), max abs diff {err:.3e}, {unskipped:.6f} equal to the "
            f"plain version with no tile skipped; on those rays "
            f"{segs} live ray-segments, {stats['tile_visits']} tile visits "
            f"({stats['tile_visits'] / segs:.3f} of {n_walk} walked tiles per ray-segment), "
            f"{stats['plane_tests']} plane tests, {stats['edge_tests']} edge tests, "
            f"{stats['sphere_tests']} sphere tests, {stats['glass_hits']} glass hits, "
            f"{stats['textured_hits']} textured hits")
        walked = ""
        if n_walk:
            walked = (f"; {stats['warp_tile_visits'] / stats['warp_segments']:.3f} of {n_walk} "
                      f"walked tiles scanned per warp-segment (per ray-segment "
                      f"{stats['tile_visits'] / segs:.3f})")
        log(f"[{tag}] warps of 32 consecutive rays, one thread a ray: "
            f"{warp_lane_share(stats['segments_per_ray']):.4f} of lanes alive per warp-segment "
            f"({stats['warp_segments']} warp-segments){walked}")
        where = ("the whole scene resident" if geo["resident"] else
                 "tile table and walk order only, records in global memory")
        if geo["axis"]:
            where += ", the axis route's pass-1 tables beside them"
        log(f"[{tag}] geometry: persistent grid of {geo['blocks']} blocks x {geo['threads']} "
            f"threads ({geo['per_sm']} a SM), {geo['registers']} registers, {geo['smem']} B "
            f"of shared memory: {where}, {n_walk} walked tiles")
        if not ok:
            raise SystemExit(f"[{tag}] FAIL: kernel disagrees with its plain version")
        if seed_row is not None and torch.equal(got, kernel(None)):
            raise SystemExit(f"[{tag}] FAIL: the noise seed row does not change the light")
        if scene.has_glass and stats["glass_hits"] == 0:
            raise SystemExit(f"[{tag}] FAIL: no ray hit glass")
        if scene.textured and stats["textured_hits"] == 0:
            raise SystemExit(f"[{tag}] FAIL: no ray hit a textured primitive")
        # Operations: 16 per plane test (two 3-term dots, the IEEE
        # reciprocal and multiply, compare, select), 16 per tested edge (two
        # 3-term dots, the affine s, two compares), 20 per sphere test (two
        # 3-term dots, the quadratic, the root, compares), ~30 per slab test
        # of a walked tile, ~60 per glass hit (the dielectric stage), 40 per
        # textured hit (TEXTURE_OPS); counted on the plain version's rays
        # and scaled.
        scale = n_rays / pick.numel()
        ops = scale * (16 * (stats["plane_tests"] + stats["edge_tests"])
                       + 20 * stats["sphere_tests"] + 30 * segs * n_walk
                       + 60 * stats["glass_hits"] + TEXTURE_OPS * stats["textured_hits"])
        n_bytes = (ori.numel() + dirs.numel() + got.numel()
                   + (0 if seed_row is None else seed_row.numel())) * 4
        entries[row] = dict(
            kernel="tracer", lib=lib, max_abs_err=err,
            ms=time_ms(kernel, 5),
            plain_ms=time_ms(plain, 1), plain_rays=pick.numel(),
            bound_ms=max(ops / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3,
            bound_by="operations" if ops / FP32_OPS_PER_S > n_bytes / HBM_BYTES_PER_S
            else "bytes",
        )
        prev = f" (before the redesign {PREV_MS[row]:.4f})" if row in PREV_MS else ""
        log(f"[{tag}] kernel {entries[row]['ms']:.4f} ms/launch{prev}, bound "
            f"{entries[row]['bound_ms']:.4f} ms by {entries[row]['bound_by']}, plain version "
            f"{entries[row]['plain_ms']:.1f} ms on {pick.numel()} rays | {smi}")
        return got

    def frame1_rays(path):
        """Frame 1's wavefront of an engine path: (rays, camera centre)."""
        cfg = configs[path]
        sc = cfg.screen
        st = init_state(cfg, seed=0, device=dev)
        ids, _ = take_chunks(st.perm, st.cursor, sc.effective_chunks_per_frame)
        if sc.sort_chunk_window:
            ids = sort_window_morton(ids, sc)
        _, key = prng.split(st.key)
        fkey = prng.fold_in(key, 1)
        pixels = chunk_pixels(chunk_origin_xy(ids, sc), sc.chunk_width)
        cam = st.camera(cfg)
        return frame_rays(cam, pixels, fkey, cfg, scenes[path].noise), cam.center

    def check_tracer(tag, row, path, programs=None):
        rays, anchor = frame1_rays(path)
        return compare_tracer(tag, row, scenes[path], configs[path].tracer, rays, anchor,
                              programs)

    check_tracer("tracer", "tracer", "main")
    check_tracer("tracer-scale", "tracer@scale", "scale", programs=SCALE_PLAIN_PROGRAMS)
    check_tracer("tracer-fuzzy", "tracer@fuzzy", "fuzzy")
    lit = check_tracer("tracer-glass", "tracer@glass", "glass")
    unlit = check_tracer("tracer-glass", "tracer@glass-no-fresnel", "glass-no-fresnel")
    (g_ori, g_dirs, g_seed, _), g_anchor = frame1_rays("glass")
    bare = trace_paths_fused(scenes["main"], g_ori, g_dirs, g_seed, configs["glass"].tracer,
                             configs["glass"].tracer.block_rows, anchor=g_anchor)
    if torch.equal(lit, unlit) or torch.equal(lit, bare):
        raise SystemExit("[tracer-glass] FAIL: fresnel or the panes change nothing")
    check_tracer("tracer-glass-tiles", "tracer@glass-scale", "glass-scale",
                 programs=SCALE_PLAIN_PROGRAMS)
    # The light does not depend on the persistent grid's size: one block
    # against the full grid, on [main]'s and [scale]'s frame 1.
    for path in ("main", "scale"):
        (g_ori, g_dirs, g_seed, g_row), g_anchor = frame1_rays(path)
        tc = configs[path].tracer
        geo_full, geo_few = {}, {}
        full = trace_paths_fused(scenes[path], g_ori, g_dirs, g_seed, tc, tc.block_rows,
                                 anchor=g_anchor, seed_row=g_row, geometry=geo_full)
        few = trace_paths_fused(scenes[path], g_ori, g_dirs, g_seed, tc, tc.block_rows,
                                anchor=g_anchor, seed_row=g_row, grid_blocks=GRID_FEW,
                                geometry=geo_few)
        same = torch.equal(full, few)
        log(f"[tracer-grid] {path}: the light of a grid of {geo_few['blocks']} blocks == that "
            f"of the full grid of {geo_full['blocks']}, bitwise: {same}")
        if not same or geo_few["blocks"] != GRID_FEW:
            raise SystemExit(f"[tracer-grid] FAIL: the light of {path} depends on the grid")
        del full, few, g_ori, g_dirs

    # The sky term: on the closed maze only rays that leak out of the world
    # gather it; on an open scene (a soup of 150 quads in two tiles) most do.
    sky_lit = check_tracer("tracer-sky", "tracer@sky", "sky")
    (s_ori, s_dirs, s_seed, _), s_anchor = frame1_rays("sky")
    sky_dark = trace_paths_fused(scenes["main"], s_ori, s_dirs, s_seed, configs["main"].tracer,
                                 configs["main"].tracer.block_rows, anchor=s_anchor)
    log(f"[tracer-sky] {int((sky_lit != sky_dark).any(dim=1).sum())} of {s_ori.shape[0]} rays "
        f"of the closed maze gather sky light")
    del sky_lit, sky_dark, s_ori, s_dirs
    rng = np.random.default_rng(3)
    soup_o = rng.uniform(-25, 25, (1 << 20, 3)).astype(np.float32)
    soup_d = rng.normal(size=(1 << 20, 3)).astype(np.float32)
    soup_d /= np.linalg.norm(soup_d, axis=-1, keepdims=True)
    soup_rays = (torch.from_numpy(soup_o).to(dev), torch.from_numpy(soup_d).to(dev),
                 torch.tensor([7], dtype=torch.int32, device=dev), None)
    soup = upload_scene(Scene(**soup_arrays()), device=dev)
    soup_tc = P.TracerConfig(bounce_limit=3, mirror_limit=2, sky_strength=0.7,
                             lighting_factor=0.25, block_rows=8)
    origin = torch.zeros(3, device=dev)
    open_lit = compare_tracer("tracer-sky-open", "tracer@sky-open", soup, soup_tc, soup_rays,
                              origin)
    open_dark = trace_paths_fused(soup, *soup_rays[:3], dataclasses.replace(
        soup_tc, sky_strength=0.0), 8, anchor=origin)
    if not float(open_lit.sum()) > float(open_dark.sum()):
        raise SystemExit("[tracer-sky-open] FAIL: the sky adds no light to an open scene")
    del open_lit, open_dark, soup_rays

    # The per-block diagnostics (the reference kernel's output rows 3-7)
    # against the plain version's: exact on every compared block, and the
    # light bitwise that of the launch without them.
    def compare_diag(tag, scene, tc, rays, anchor, programs=None):
        ori, dirs, seed, seed_row = rays
        block = tc.block_rows
        n_rays, b = ori.shape[0], block * 128
        kernel = lambda diag: trace_paths_fused(
            scene, ori, dirs, seed, tc, block, anchor=anchor, seed_row=seed_row,
            return_block_segments=diag)
        light, got = kernel(True)
        if not torch.equal(light, kernel(False)):
            raise SystemExit(f"[{tag}] FAIL: asking for the diagnostics changes the light")
        n_blocks = -(-n_rays // b)
        if programs is None:
            blocks = torch.arange(n_blocks, device=dev)
            _, want = trace_paths_plain(scene, ori, dirs, seed, tc, block, anchor=anchor,
                                        seed_row=seed_row, return_block_segments=True)
        else:
            blocks = torch.arange(programs, device=dev) * ((n_rays // b) // programs)
            pick = (blocks[:, None] * b + torch.arange(b, device=dev)).reshape(-1)
            _, want = trace_paths_plain(
                scene, ori[pick], dirs[pick], seed, tc, block, anchor=anchor,
                seed_row=None if seed_row is None else seed_row[pick], ray_ids=pick,
                return_block_segments=True)
        torch.cuda.synchronize()
        same = (got[:, blocks] == want[:, blocks])
        segs, tiles, tiles0, _, live = (got[r].double() for r in range(5))
        with_ms = time_ms(lambda: kernel(True), 5)
        without_ms = time_ms(lambda: kernel(False), 5)
        prev = (" (before the redesign: 2.0404 with, 1.4688 without, +38.9%)"
                if tag == "tracer-diag" else "")
        log(f"[{tag}] {n_rays} rays in {n_blocks} blocks of B={b}, diagnostics [5, {got.shape[1]}] "
            f"against the plain version's on {blocks.numel()} blocks: rows 3-7 equal on "
            f"{', '.join(f'{float(x):.6f}' for x in same.double().mean(dim=1))} of blocks "
            f"(need 1 each) | segments per block {float(segs.mean()):.3f} (most "
            f"{int(segs.max())} of {tc.max_segments}), tiles per block-segment "
            f"{float(tiles.sum() / segs.sum()):.3f} ({float(tiles0.mean()):.3f} on the primary "
            f"segment), live rays per block-segment {float(live.sum() / (segs.sum() * b)):.4f} "
            f"of B | kernel {with_ms:.4f} ms/launch with diagnostics, {without_ms:.4f} without, "
            f"{with_ms / without_ms - 1:+.1%}{prev} | {smi}")
        if got.dtype != torch.int32 or tuple(got.shape) != (5, n_blocks) or not bool(same.all()):
            raise SystemExit(f"[{tag}] FAIL: the diagnostics differ from the plain version's")
        return with_ms

    diag_ms = compare_diag("tracer-diag", scenes["main"], configs["main"].tracer,
                           *frame1_rays("main"))
    compare_diag("tracer-diag-scale", scenes["scale"], configs["scale"].tracer,
                 *frame1_rays("scale"), programs=SCALE_PLAIN_PROGRAMS)
    # ... and through the entry point a user calls, with the launch counted.
    (d_ori, d_dirs, _, _), d_anchor = frame1_rays("main")
    kernels.reset_launches()
    hist = tracer_segment_histogram(scenes["main"], configs["main"], d_ori, d_dirs,
                                    rows_per_block=configs["main"].tracer.block_rows,
                                    anchor=d_anchor)
    launches_diag = dict(kernels.launches)
    log(f"[tracer-diag] tracer_segment_histogram on [main]'s frame 1: {json.dumps(hist)}, "
        f"launches {launches_diag}")
    if launches_diag != {"tracer_diag": 1} or sum(hist["histogram"]) != -(-d_ori.shape[0] // (
            configs["main"].tracer.block_rows * 128)):
        raise SystemExit("[tracer-diag] FAIL: the histogram did not come from the kernel")
    entries["tracer@diag"] = dict(entries["tracer"], lib="tracer_diag", ms=diag_ms)
    del d_ori, d_dirs

    # 5. The golden scripted run on the card against the committed frame.
    gcfg = golden_config()
    script = golden_script(FrameInputs)
    _, frame = run_scripted(upload_scene(build_scene(gcfg.maze), device=dev), gcfg,
                            inputs=script)
    golden = os.path.join(ROOT, "tests", "goldens", "script_pallas.npz")
    with np.load(golden) as z:
        ref = z["img"]
    diff = np.abs(frame.astype(int) - ref.astype(int))
    within = float((diff <= 1).mean())
    log(f"[golden] 28-frame scripted run on the card vs tests/goldens/script_pallas.npz: "
        f"{within:.6f} of pixels within 1 LSB (need > 0.999), max diff {diff.max()} "
        f"(need <= 4)")
    if not (within > 0.999 and diff.max() <= 4):
        raise SystemExit("[golden] FAIL")

    # 6. The driven paths: each configuration at full width, scripted, with
    # the launch counts set to 0 just before and read just after. Every
    # frame of make_scan_step is a replay of a captured graph (the first
    # frame of each input kind eager: the warm-up call steps one of each);
    # the same script through the eager loop must give the same state and
    # frame, bitwise.
    def drive(path, script=None):
        """Run ``path``'s configuration through its script (or another
        path's): (launch counts, last frame)."""
        cfg, scene = configs[path], scenes[path]
        sc = cfg.screen
        idle, walk, turn, idle2 = SCRIPTS[script or path]
        turning = FrameInputs.make(mouse_dx=-27.0)
        inputs = ([FrameInputs.idle()] * idle + [FrameInputs.make(w=True)] * walk
                  + [turning] * turn + [FrameInputs.idle()] * idle2)
        release()
        run = make_scan_step(scene, cfg)
        run(init_state(cfg, seed=0, device=dev), [FrameInputs.idle(), turning])  # first-use costs
        torch.cuda.synchronize()
        graphs = only_graphs(run.runner)
        replays = graphs.replays
        st = init_state(cfg, seed=0, device=dev)
        start_center = st.cam_center.clone()
        kernels.reset_launches()
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        wall = time.perf_counter()
        t_start.record()
        st, frame = run(st, inputs)
        t_end.record()
        checksum = int(frame.to(torch.int64).sum())  # host fetch ends the run
        wall = time.perf_counter() - wall
        counts = dict(kernels.launches)
        n_frames = len(inputs)
        ms_frame = t_start.elapsed_time(t_end) / n_frames
        rays = sc.effective_chunks_per_frame * sc.pixels_per_chunk * sc.samples_per_pixel
        moved = float((st.cam_center - start_center).abs().max())
        replays = (graphs.replays - replays) / n_frames
        eager_run = make_scan_step_fn(cfg, n_frames)
        (est, eframe), eager_ms = timed(lambda: eager_run(scene, init_state(cfg, seed=0,
                                                                            device=dev), inputs))
        same = states_bitwise(st, est) and torch.equal(frame, eframe)
        cfg_name = {"main": "interactive", "glass": "interactive + glass_prob 0.5",
                    "glass-scale": "scale + glass_prob 0.5",
                    "sky": "interactive + sky_strength 0.7"}.get(path, path)
        tag = path if script is None else f"{path} on {script}'s script"
        log(f"[{tag}] config_{cfg_name} {sc.width}x{sc.height} {sc.samples_per_pixel} spp, "
            f"{n_frames} frames ({idle} idle, {walk} walk, {turn} turn, {idle2} idle), "
            f"{rays} rays/frame: {ms_frame:.3f} ms/frame, "
            f"{rays / ms_frame / 1e3:.2f} Mrays/s (host wall {wall:.2f} s), checksum "
            f"{checksum}, camera moved {moved:.3f}, launches {counts}; graph {replays:g} "
            f"replays/frame, eager loop {eager_ms / n_frames:.3f} ms/frame, graph == eager "
            f"bitwise {same}; {graph_line(graphs)} | {smi}")
        if not same:
            raise SystemExit(f"[{path}] FAIL: the graph's state or frame is not the eager step's")
        display = frame.to(torch.float32)
        if not (tuple(frame.shape) == (sc.height, sc.width, 3) and frame.dtype == torch.uint8
                and float(display.mean()) > 1.0 and moved > 0.0
                and torch.isfinite(st.screen).all()):
            raise SystemExit(f"[{path}] FAIL: frame blank or malformed, or the camera "
                             "did not move")
        if (others(counts) != {"tracer": n_frames, "present": n_frames, **glue(n_frames)}
                or {k: counts.get(k, 0) for k in ("threefry", "threefry_uniform")}
                != step_draws(cfg, inputs)):
            raise SystemExit(f"[{path}] FAIL: launches {counts} != {n_frames} frames each, or "
                             f"the draws not {step_draws(cfg, inputs)}")
        return counts, frame

    launches = {path: drive(path)[0] for path in ("main", "scale", "fuzzy")}
    launches["glass-scale"] = drive("glass-scale", script="bands-4k")[0]
    launches["glass"], glass_frame = drive("glass")
    if torch.equal(glass_frame, drive("main", script="glass")[1]):
        raise SystemExit("[glass] FAIL: the frame is the glass-free maze's")
    launches["sky"] = drive("sky")[0]

    # adaptive_refresh: idle until the chunk queue has wrapped once; at the
    # wrap the queue is reordered by the screen's detail, on the device.
    acfg = dataclasses.replace(configs["main"], screen=dataclasses.replace(
        configs["main"].screen, adaptive_refresh=True))
    asc = acfg.screen
    epoch = -(-asc.total_chunks // asc.effective_chunks_per_frame)
    release()
    arun = make_scan_step(scenes["main"], acfg)
    ast = init_state(acfg, seed=0, device=dev)
    kernels.reset_launches()
    ast, _ = arun(ast, [FrameInputs.idle()] * (epoch - 1))
    before = ast.perm.clone()
    a_start = torch.cuda.Event(enable_timing=True)
    a_end = torch.cuda.Event(enable_timing=True)
    a_start.record()
    ast, aframe = arun(ast, [FrameInputs.idle()] * 9)
    a_end.record()
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    is_perm = torch.equal(ast.perm.sort().values.to(torch.int64),
                          torch.arange(asc.total_chunks, device=dev))
    moved_share = float((ast.perm != before).float().mean())
    est, _ = make_scan_step_fn(acfg, epoch - 1)(scenes["main"], init_state(acfg, seed=0,
                                                                           device=dev),
                                                [FrameInputs.idle()] * (epoch - 1))
    (est, eframe), a_eager_ms = timed(lambda: make_scan_step_fn(acfg, 9)(
        scenes["main"], est, [FrameInputs.idle()] * 9))
    same = states_bitwise(ast, est) and torch.equal(aframe, eframe)
    log(f"[adaptive] config_interactive + adaptive_refresh, {epoch - 1} + 9 idle frames (the "
        f"queue of {asc.total_chunks} chunks wraps on frame {epoch}): queue still a permutation "
        f"{is_perm}, {moved_share:.4f} of its places changed at the wrap, "
        f"{a_start.elapsed_time(a_end) / 9:.3f} ms/frame over the last 9, launches {counts}; "
        f"eager loop {a_eager_ms / 9:.3f} ms/frame over the last 9, graph == eager bitwise "
        f"{same}; {graph_line(only_graphs(arun.runner))} | {smi}")
    if not (is_perm and moved_share > 0.5 and float(aframe.float().mean()) > 1.0):
        raise SystemExit("[adaptive] FAIL: the queue was not reordered at the wrap")
    if not same:
        raise SystemExit("[adaptive] FAIL: the graph's state or frame is not the eager step's")
    if counts != {"tracer": epoch + 8, "present": epoch + 8, **glue(epoch + 8),
                  **nonzero(step_draws(acfg, [FrameInputs.idle()] * (epoch + 8)))}:
        raise SystemExit(f"[adaptive] FAIL: launches {counts}")
    del ast, aframe, before, arun, est, eframe

    # The row-band engine: the screen cut into bands, every band on this
    # one card. Camera against the single engine's, the kernel present
    # against the plain halo blur, launches counted; one graph per input kind
    # holds every band's step, the halo rows and the halo presents, and the
    # same body stepped eagerly must give the same state and frame, bitwise.
    def drive_bands(tag, path, n_bands):
        cfg, scene = configs[path], scenes[path]
        sc = cfg.screen
        idle, walk, turn, idle2 = SCRIPTS.get(tag, SCRIPTS["glass"])
        turning = FrameInputs.make(mouse_dx=-27.0)
        inputs = ([FrameInputs.idle()] * idle + [FrameInputs.make(w=True)] * walk
                  + [turning] * turn + [FrameInputs.idle()] * idle2)
        devices = [dev] * n_bands
        release()
        init_fn, scan_fn = shard.make_sharded_scan_engine(cfg, devices)
        scan_fn(scene, init_fn(0), [FrameInputs.idle(), turning])   # first-use costs
        torch.cuda.synchronize()
        graphs = only_graphs(scan_fn.runner_of(scene))
        replays = graphs.replays
        st = init_fn(0)
        kernels.reset_launches()
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        t_start.record()
        st, frame = scan_fn(scene, st, inputs)
        t_end.record()
        checksum = int(frame.to(torch.int64).sum())             # host fetch ends the run
        counts = dict(kernels.launches)
        n_frames = len(inputs)
        ms_frame = t_start.elapsed_time(t_end) / n_frames
        replays = (graphs.replays - replays) / n_frames
        eager = StepRunner(scan_fn.runner_of(scene)._body, graphs=False)
        est, eager_ms = timed(lambda: run_frames(eager, init_fn(0), inputs))
        eframe = shard.assemble_frame(shard.band_frames(est, shard._band_screen_cfg(cfg,
                                                                                    n_bands)))
        same = states_bitwise(st, est) and torch.equal(frame, eframe)
        band = shard._band_screen_cfg(cfg, n_bands)
        rays = (n_bands * band.effective_chunks_per_frame * sc.pixels_per_chunk
                * sc.samples_per_pixel)
        plain_cfg = dataclasses.replace(cfg, screen=dataclasses.replace(
            sc, pallas_present=False))
        p_init, p_scan = shard.make_sharded_scan_engine(plain_cfg, devices)
        pst, pframe = p_scan(scene, p_init(0), inputs)
        sst, _ = make_scan_step(scene, cfg)(init_state(cfg, seed=0, device=dev), inputs)
        torch.cuda.synchronize()
        screens = all(torch.equal(a, b) for a, b in zip(st.screen, pst.screen))
        camera = all(torch.equal(getattr(st, f)[t], getattr(sst, f))
                     for f in ("cam_center", "quat", "half_theta") for t in range(n_bands))
        log(f"[{tag}] config_{path if path != 'main' else 'interactive'} {sc.width}x{sc.height} "
            f"as {n_bands} bands of {band.height} rows, ALL ON THIS ONE CARD (not a multi-GPU "
            f"number), {n_frames} frames ({idle} idle, {walk} walk, {turn} turn, {idle2} idle), "
            f"{rays} rays/frame: {ms_frame:.3f} ms/frame, {rays / ms_frame / 1e3:.2f} Mrays/s, "
            f"checksum {checksum}, camera == the single engine's {camera}, band screens == the "
            f"plain halo blur's bitwise {screens}, launches {counts}; graph {replays:g} "
            f"replays/frame, eager loop {eager_ms / n_frames:.3f} ms/frame, graph == eager "
            f"bitwise {same}; {graph_line(graphs)} | {smi}")
        if not (tuple(frame.shape) == (sc.height, sc.width, 3) and frame.dtype == torch.uint8
                and float(frame.float().mean()) > 1.0 and camera and screens
                and torch.equal(frame, pframe) and same):
            raise SystemExit(f"[{tag}] FAIL: frame malformed, or the camera or the present "
                             "disagrees")
        if not holds(counts, {"tracer": n_bands * n_frames, "present_halo": n_bands * n_frames,
                              **glue(n_bands * n_frames)}, True):
            raise SystemExit(f"[{tag}] FAIL: launches {counts}")
        launches[tag] = counts

    drive_bands("bands", "main", 2)
    drive_bands("bands-4k", "scale", 4)
    graph_phase(dev, smi, configs["main"], scenes["main"])
    release()

    # 7. The offline renders through render_full_frame: the kernel against
    # its plain version on one block of pixel rows, then the whole frame.
    def gallery_rays(scene, cfg):
        """(rays of the compared block of pixel rows, camera, frame key)."""
        cam = make_camera(cfg.camera, 1.0, dev)
        key = prng.PRNGKey(0, device=dev)
        pix, bkey = list(frame_row_batches(cfg, key, GALLERY_ROWS, dev))[GALLERY_BATCH]
        return frame_rays(cam, pix, bkey, cfg, scene.noise), cam, key

    def gallery(tag, row, scene, cfg):
        rays, cam, key = gallery_rays(scene, cfg)
        compare_tracer(f"tracer-{tag}", row, scene, cfg.tracer, rays, cam.center,
                       programs=GALLERY_PLAIN_PROGRAMS)
        del rays
        lib = "tracer_tex" if scene.textured else "tracer"
        render_full_frame(scene, cam, key, cfg, GALLERY_ROWS)    # first-launch costs
        torch.cuda.synchronize()
        kernels.reset_launches()
        wall = time.perf_counter()
        frame = render_full_frame(scene, cam, key, cfg, GALLERY_ROWS)
        mean = float(frame.mean())                               # host fetch ends the run
        wall = time.perf_counter() - wall
        counts = dict(kernels.launches)
        sc = cfg.screen
        rays_frame = sc.width * sc.height * sc.samples_per_pixel
        log(f"[{tag}] {sc.width}x{sc.height} {sc.samples_per_pixel} spp, aperture "
            f"{cfg.camera.aperture}, focus {cfg.camera.focus_dist:.3f}, {rays_frame} rays: "
            f"{wall * 1e3:.1f} ms/frame, {rays_frame / wall / 1e6:.2f} Mrays/s, mean {mean:.5f}, "
            f"launches {counts} | {smi}")
        if not (tuple(frame.shape) == (sc.height, sc.width, 3) and torch.isfinite(frame).all()
                and mean > 0.02 and float(frame.std()) > 0.01):
            raise SystemExit(f"[{tag}] FAIL: frame blank or malformed")
        batches = sc.height // GALLERY_ROWS
        if not holds(counts, {lib: batches, **glue(renders=batches)}, True):
            raise SystemExit(f"[{tag}] FAIL: launches {counts}")
        launches[tag] = counts
        return frame

    focus = float(np.linalg.norm(np.subtract(CORNELL_GLASS_CENTRE, GALLERY_SPAWN)))
    glass_box = upload_scene(cornell_scene("glass"), device=dev)
    lens = gallery("cornell-glass", "tracer@cornell-glass", glass_box,
                   gallery_config(GALLERY_SIZE, GALLERY_SPP, aperture=0.15, focus_dist=focus))
    pin_cfg = gallery_config(GALLERY_SIZE, GALLERY_SPP)
    pinhole = render_full_frame(glass_box, make_camera(pin_cfg.camera, 1.0, dev),
                                prng.PRNGKey(0, device=dev), pin_cfg, GALLERY_ROWS)
    blur = float((lens - pinhole).abs().mean())
    log(f"[cornell] glass variant, thin lens against pinhole: mean abs difference {blur:.5f}")
    if not blur > 1e-3:
        raise SystemExit("[cornell] FAIL: the thin lens changes nothing")
    del lens, pinhole
    sphere_box = upload_scene(cornell_scene("spheres"), device=dev)
    unmoved = gallery("cornell-spheres", "tracer@cornell-spheres", sphere_box, pin_cfg)
    mesh_scene = mesh_gallery_scene()
    gallery("mesh", "tracer@mesh", upload_scene(mesh_scene, device=dev), pin_cfg)

    # Glass triangles (test mode 7): the gallery's three meshes made glass.
    glass_mesh = dataclasses.replace(mesh_scene, ior=np.where(
        np.asarray(mesh_scene.kind) == 3, 1.5, np.asarray(mesh_scene.ior)).astype(np.float32))
    glass_mesh = upload_scene(glass_mesh, device=dev)
    if glass_mesh.mode_counts[7] == 0:
        raise SystemExit("[mesh-glass] FAIL: the scene has no glass triangle")
    gallery("mesh-glass", "tracer@glass-tri", glass_mesh, pin_cfg)
    del glass_mesh

    # The in-step sphere refresh: the diffuse sphere moved on the device.
    refresh = make_sphere_refresh(sphere_box)
    centre = sphere_box.sph_center.clone()
    centre[1] += torch.tensor([0.7, -0.5, 0.3], device=dev)
    moved_box = refresh(sphere_box._replace(sph_center=centre))
    rays, cam, key = gallery_rays(moved_box, pin_cfg)
    compare_tracer("sphere-refresh", "tracer@sphere-refresh", moved_box, pin_cfg.tracer, rays,
                   cam.center, programs=GALLERY_PLAIN_PROGRAMS // 4)
    del rays
    moved_frame = render_full_frame(moved_box, cam, key, pin_cfg, GALLERY_ROWS)
    shift = float((moved_frame - unmoved).abs().mean())
    log(f"[sphere-refresh] cornell-spheres, sphere 1 moved by (0.7, -0.5, 0.3) on the device "
        f"and refreshed: frame against the unmoved one, mean abs difference {shift:.5f}")
    if not shift > 1e-4 or make_sphere_refresh(scenes["main"]) is not None:
        raise SystemExit("[sphere-refresh] FAIL: the moved sphere changes nothing")
    del moved_frame, unmoved

    # The texture stage: the Cornell box with two blocks, a checker floor
    # (UV checker) and a world-checker wall; with a world-checker sphere; and
    # in many tiles, the mesh gallery with a checker floor.
    tex_box = gallery("cornell-checker", "tracer@tex",
                      upload_scene(textured_cornell("blocks"), device=dev), pin_cfg)
    bare_box = upload_scene(cornell_scene("blocks"), device=dev)
    cam = make_camera(pin_cfg.camera, 1.0, dev)
    bare = render_full_frame(bare_box, cam, prng.PRNGKey(0, device=dev), pin_cfg, GALLERY_ROWS)
    tex_shift = float((tex_box - bare).abs().mean())
    log(f"[cornell-checker] against the untextured box: mean abs difference {tex_shift:.5f}")
    if not tex_shift > 1e-3:
        raise SystemExit("[cornell-checker] FAIL: the frame is the untextured box's")
    del tex_box, bare
    for tag, scene in (("tracer-tex-spheres", textured_cornell("spheres")),
                       ("tracer-tex-tiles", checker_floor(mesh_scene))):
        scene = upload_scene(scene, device=dev)
        rays, cam, _ = gallery_rays(scene, pin_cfg)
        compare_tracer(tag, tag.replace("tracer-", "tracer@"), scene, pin_cfg.tracer, rays,
                       cam.center, programs=GALLERY_PLAIN_PROGRAMS // 4)
        del rays

    # 8. The jnp tracer's backends (brute, exact, bvh), the offline path and
    # checkpoints: each phase prints its seconds, and its kernels' launch
    # counts are set to 0 just before it and read just after.
    jnp = jnp_phases(dev, smi)

    # 9. The drivers: the CLI, terminal play, the HTTP server, multiplayer
    # and the offline commands, at full width; each phase prints its seconds
    # and the launches counted around it.
    driver_phases(dev, smi)

    # 10. The repository's own entry points on the port: the bench, its
    # --validate and --sharded-bands, the soak and the examples.
    entry = entry_phases(dev, smi)

    # One row per kernel and path; a row's launches are its path's.
    rows = (("tracer", "main"), ("tracer@scale", "scale"), ("tracer@fuzzy", "fuzzy"),
            ("tracer@glass", "glass"), ("tracer@glass-scale", "glass-scale"),
            ("tracer@cornell-glass", "cornell-glass"),
            ("tracer@cornell-spheres", "cornell-spheres"), ("tracer@mesh", "mesh"),
            ("tracer@sky", "sky"), ("tracer@glass-tri", "mesh-glass"),
            ("tracer@tex", "cornell-checker"), ("tracer@diag", "diag"),
            ("present", "main"), ("present@4k", "scale"),
            ("present-halo", "bands"), ("present-halo@4k", "bands-4k"))
    launches["diag"] = launches_diag
    kern = []
    for row, path in rows:
        e = entries[row]
        k = e["kernel"]
        kern.append(dict(name=row, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
                         launches=launches[path][e["lib"]], max_abs_err=e["max_abs_err"],
                         ms=e["ms"], plain_ms=e["plain_ms"],
                         plain_rays=e.get("plain_rays"), bound_ms=e["bound_ms"],
                         bound_by=e["bound_by"], library_ms=None))
    # The walk kernel's rows: on [bvh]'s frame-1 rays with [bvh]'s launches;
    # on config_interactive's frame-1 rays with the launches [bench-bvh]'s
    # eager loop made at a frame's first segment; on that frame's later
    # segments, every ray walked, with those it made at the others without
    # a live-id list (none since the walk reads the list), and the live rays
    # only with those it made with the list; on config_scale's frame-1 rays
    # at every segment with [scale-bvh]'s. No PyTorch call computes a BVH
    # walk, so library_ms is null.
    bench_bvh = entry["bench-bvh"]
    for row, walk_set, n in (("bvh_walk", "config_bvh", jnp["launches"]["bvh"]),
                             ("bvh_walk@interactive", "interactive", bench_bvh["walk_first"]),
                             ("bvh_walk@bounce", "bounce",
                              bench_bvh["walk_later"] - bench_bvh["walk_listed"]),
                             ("bvh_walk@live", "live", bench_bvh["walk_listed"]),
                             ("bvh_walk@scale", "scale", jnp["launches"]["scale-bvh"])):
        e = jnp["walk"][walk_set]
        kern.append(dict(name=row, route="cuda", source=SOURCES["bvh_walk"],
                         replaces=REPLACES["bvh_walk"], launches=n,
                         max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
                         plain_rays=e["plain_rays"], bound_ms=e["bound_ms"],
                         bound_by=e["bound_by"], library_ms=None))
    # The threefry kernel's rows: [main]'s jitter draw with [main]'s uniform
    # launches, [bench-bvh]'s unit_sphere draw with that bench's full normal
    # launches (a frame's first segment; PyTorch's generators are Philox:
    # no torch call computes threefry, so library_ms is null), the same
    # draw on the live-id lists of segments 1 and 6 with that bench's listed
    # launches (segments 1-12), and erf_inv on that draw's uniforms with
    # that bench's erf_inv launches (a normal runs erf_inv inside its own
    # launch), beside torch.special.erfinv as library_ms.
    for row, n in (("threefry@jitter", launches["main"].get("threefry_uniform", 0)),
                   ("threefry@normal", bench_bvh["threefry_normal"]),
                   *((f"threefry@normal-live{it}", bench_bvh["threefry_normal_listed"])
                     for it in NORMAL_LIVE_SEGMENTS),
                   ("threefry@erfinv", bench_bvh["threefry_erf_inv"])):
        e = entries[row]
        kern.append(dict(name=row, route="cuda", source=SOURCES["threefry"],
                         replaces=REPLACES[row], launches=n, max_abs_err=e["max_abs_err"],
                         ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
                         bound_by=e["bound_by"], library_ms=e.get("library_ms")))
    # The shade kernel's row: [bench-bvh]'s frame-1 rays at its 13 segments,
    # with that bench's shade launches. No PyTorch call computes a segment,
    # so library_ms is null.
    e = jnp["shade"]["shade@interactive"]
    kern.append(dict(name="shade@interactive", route="cuda", source=SOURCES["shade"],
                     replaces=REPLACES["shade"], launches=bench_bvh["shade"],
                     max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
                     bound_ms=e["bound_ms"], bound_by=e["bound_by"], library_ms=None))
    # The glue kernels' rows: [main]'s and config_scale's frame 1, with their
    # paths' launches. No single PyTorch call computes a frame's setup (a
    # gather, a sort, a move, a box test and a key chain), its camera rays
    # (a rotation and a threefry draw) or the resolve (a root, a mean and a
    # row scatter), so library_ms is null.
    launches.update(big_launches)
    for row, path in (("frame_setup", "main"), ("frame_setup@scale", "scale"),
                      ("frame_setup@8k", "scale-8k"),
                      ("camera_rays", "main"), ("camera_rays@scale", "scale"),
                      ("resolve", "main"), ("resolve@scale", "scale"),
                      ("resolve@4096spp", "spp4096")):
        e = entries[row]
        k = e["kernel"]
        kern.append(dict(name=row, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
                         launches=launches[path].get(k, 0), max_abs_err=e["max_abs_err"],
                         ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
                         bound_by=e["bound_by"], library_ms=None))
        if k == "frame_setup" and path in BIG_PATHS:
            # The tiled route's merge passes, launched by the same C entry
            # and timed inside the row's ms.
            kern[-1]["merge_launches"] = launches[path].get("frame_setup_merge", 0)
    log(json.dumps({"kernels": kern}))
    count = torch.cuda.device_count()
    if count != 1:
        raise SystemExit(f"[device] FAIL: {count} cards visible, the smoke drives one")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
