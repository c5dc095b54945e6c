#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``mirror_maze_tpu_torch/csrc`` (nvcc,
sm_90a: the tracer's four libraries, with and without the texture stage and
the diagnostics, and the present), holds each against its plain PyTorch
version on the card at the shapes of every path it drives, checks the
engine's scripted run against the committed golden frame, and drives four
configurations at full width through ``make_scan_step``:

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

Then the jnp tracer's backends (render/intersect.py, render/tracer.py; no
kernel of their own, the present kernel presents their frames), the offline
path and checkpoints, each phase with its seconds:

- ``[golden-brute]`` the golden configuration with ``intersector="brute"``:
  ``render_full_frame`` and the 28-frame script against
  ``tests/goldens/frame_brute.npz`` and ``script_brute.npz``;
- ``[v0]`` ``config_v0`` (4x4 maze, 256x256, 1 spp, brute), 40 frames, and
  the same script on the CPU in this process, by the golden rule;
- ``[bvh]`` / ``[exact]`` ``config_bvh``'s scene (8x8 maze, 512x384, 4 spp,
  5 + 4 bounces) with the traversal and with the dense exact test, 8 frames
  each, their last frames against each other; the walk's host check every
  k iterations timed on frame 1's rays;
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
- ``[multiplayer]`` two player processes over gloo on the one card: ms/frame
  each, the gathered positions, player 1's avatar in player 0's view;
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
- ``[soak]`` the kernel exactness soak (``tools/soak_kernel.py``): 40 random
  soups of 65,536 rays, the kernel bitwise its plain version under the
  default grid and one of 1 or 7 blocks, and within 1e-4 of the jnp tracer
  on >= 99% of rays;
- ``[examples]`` the Cornell box and the mesh gallery (``--intersector
  pallas --size 256 --spp 64``) in subprocesses, their PNGs bitwise the
  in-process render, and the multiplayer demo (3 players, 24 frames): every
  process exits 0, the GIF has 6 frames, each walker ends past its spawn.

Every phase prints one line; any failure exits non-zero. The last two lines
are the ``{"kernels": [...]}`` summary (one row per kernel and path, every
number measured or, for ``bound_ms``, computed in this run) and ``{"ok":
true, "device": {...}}``.

Needs a CUDA card: without one it exits 2 and prints no result. It uses
the first visible card only (the multiplayer phase's two processes share
it). Imports torch and numpy, the port and the port's JAX-free test helpers
(``tests/_torch_tools.py``) and ``time_present.py``, nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peak (NVIDIA data sheet; dense, at the 700 W limit);
# the memory rate is time_present.py's HBM_BYTES_PER_S.
FP32_OPS_PER_S = 67e12

# The TPU kernels these replace (file:line of the function that reaches
# pl.pallas_call in the JAX package).
REPLACES = {
    "tracer": "mirror_maze_tpu/render/pallas_tracer.py:639",
    "present": "mirror_maze_tpu/render/present.py:44",
}
SOURCES = {
    "tracer": "mirror_maze_tpu_torch/csrc/tracer.cu",
    "present": "mirror_maze_tpu_torch/csrc/present.cu",
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
# The kernel whose scan loops the build's SASS is read for: the resident,
# quads-only one-tile instantiation (RESIDENT, no WALK, SKY, PRIMS, GLASS,
# TEX or DIAG).
SASS_KERNEL = "_Z12trace_kernelILb1ELb0ELb0ELb0ELb0ELb0ELb0EEv6Params"
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


def jnp_phases(dev, smi: str) -> None:
    """The phases of the jnp tracer's backends, the offline path and the
    checkpoints; any failure ends the run with SystemExit."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    import mirror_maze_tpu_torch as P
    from _torch_tools import golden_config, golden_script
    from mirror_maze_tpu_torch import bench, kernels
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.render import campath, intersect, make_camera, upload_scene
    from mirror_maze_tpu_torch.render.pipeline import (
        camera_rays,
        frame_row_batches,
        render_full_frame,
    )
    from mirror_maze_tpu_torch.render.scheduler import chunk_origin_xy, chunk_pixels, take_chunks
    from mirror_maze_tpu_torch.runtime.loop import run_scripted
    from mirror_maze_tpu_torch.runtime.state import (
        EngineState,
        FrameInputs,
        init_state,
        load_state,
        save_state,
    )
    from mirror_maze_tpu_torch.runtime.step import derive_traversal_bounds, make_scan_step
    from mirror_maze_tpu_torch.scene import build_scene
    from mirror_maze_tpu_torch.utils import imageio

    def timed(fn):
        """(result, device ms) of fn, ended by a synchronize."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    # [golden-brute]: the brute backend's frame and script against the
    # committed goldens.
    t0 = time.perf_counter()
    gcfg = golden_config().replace(intersector="brute")
    gscene = upload_scene(build_scene(gcfg.maze), device=dev)
    gcam = make_camera(gcfg.camera, gcfg.screen.width / gcfg.screen.height, dev)
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
            and counts == {"present": 28}):
        raise SystemExit("[golden-brute] FAIL")

    # [v0]: config_v0 at full size, on the card and on the CPU.
    t0 = time.perf_counter()
    cfg = P.NAMED_CONFIGS["v0"]()
    sc = cfg.screen
    inputs = _script(FrameInputs, JNP_SCRIPTS["v0"])
    run = make_scan_step(upload_scene(build_scene(cfg.maze), device=dev), cfg)
    run(init_state(cfg, device=dev), inputs[:2])                 # first-call costs
    torch.cuda.synchronize()
    st0 = init_state(cfg, seed=0, device=dev)
    kernels.reset_launches()
    (st, frame), ms = timed(lambda: run(st0, inputs))
    counts = dict(kernels.launches)
    n = len(inputs)
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
        f"{counts}; {time.perf_counter() - t0:.1f} s | {smi}")
    if not (within > 0.999 and worst <= 4 and same_state and cam_diff <= 1e-6
            and float(frame.float().mean()) > 0.1 and counts == {"present": n}):
        raise SystemExit("[v0] FAIL")

    # [bvh] and [exact]: config_bvh's scene (8x8 maze, 512x384, 4 spp, 5 + 4
    # bounces) with the traversal and with the dense exact backend.
    base = P.NAMED_CONFIGS["bvh"]()
    bscene = upload_scene(build_scene(base.maze), device=dev)
    inputs = _script(FrameInputs, JNP_SCRIPTS["bvh"])
    n = len(inputs)
    sc = base.screen
    rays = sc.effective_chunks_per_frame * sc.pixels_per_chunk * sc.samples_per_pixel
    last = {}
    for backend in ("bvh", "exact"):
        t0 = time.perf_counter()
        cfg = base.replace(intersector=backend)
        run = make_scan_step(bscene, cfg)
        run(init_state(cfg, device=dev), inputs[:1])            # first-call costs
        torch.cuda.synchronize()
        st0 = init_state(cfg, seed=0, device=dev)
        kernels.reset_launches()
        intersect.walk_counts.clear()
        (st, frame), ms = timed(lambda: run(st0, inputs))
        counts, walks = dict(kernels.launches), dict(intersect.walk_counts)
        walked = ""
        if backend == "bvh":
            per_walk = walks["iterations"] / walks["walks"]
            walked = (f", {walks['syncs'] / n:.1f} host syncs/frame (every "
                      f"{intersect.CHECK_EVERY} iterations), {per_walk:.1f} iterations/walk, "
                      f"bounds {derive_traversal_bounds(bscene, cfg, None, None)}")
        log(f"[{backend}] config_bvh scene {sc.width}x{sc.height} {sc.samples_per_pixel} spp, "
            f"{cfg.tracer.bounce_limit} + {cfg.tracer.mirror_limit} bounces, intersector "
            f"{backend}, {n} frames, {rays} rays/frame: {ms / n:.1f} ms/frame, "
            f"{rays / (ms / n) / 1e3:.3f} Mrays/s{walked}, checksum "
            f"{int(frame.to(torch.int64).sum())}; launches {counts}; "
            f"{time.perf_counter() - t0:.1f} s | {smi}")
        if counts != {"present": n} or float(frame.float().mean()) <= 1.0:
            raise SystemExit(f"[{backend}] FAIL: launches {counts} or a blank frame")
        last[backend] = frame.cpu().numpy()
    within, worst = _golden_rule(last["bvh"], last["exact"])
    log(f"[bvh] last frame vs [exact]'s: {within:.6f} within 1 LSB, max diff {worst}")
    if not (within > 0.999 and worst <= 4):
        raise SystemExit("[bvh] FAIL: the bvh and exact runs disagree")
    # The walk's host check interval on frame 1's rays: the result is the
    # same for every interval, the time is not.
    cfg = base.replace(intersector="bvh")
    st = init_state(cfg, device=dev)
    ids, _ = take_chunks(st.perm, st.cursor, sc.effective_chunks_per_frame)
    pixels = chunk_pixels(chunk_origin_xy(ids, sc), sc.chunk_width)
    _, key = prng.split(st.key)
    ori, dirs, _, _ = camera_rays(st.camera(cfg), pixels, prng.fold_in(key, 1), cfg)
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
            raise SystemExit(f"[bvh] FAIL: check_every={k} changes the walk's result")
        times.append(f"k={k} {ms / WALK_REPEATS:.2f} ms")
    log(f"[bvh] one walk of frame 1's {ori.shape[0]} rays, host check every k iterations "
        f"(mean of {WALK_REPEATS}; the default is k={intersect.CHECK_EVERY}): {', '.join(times)} "
        f"(results bitwise equal) | {smi}")

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
    ok = np.isfinite(ref).all() and ref.max() > 0.0 and counts == {"tracer": batches}
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
            and counts == {"tracer": n * batches}):
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
    if not (loaded and same and counts == {"tracer": total, "present": total}):
        raise SystemExit("[resume] FAIL")


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
# frames, then the CLI's configuration arguments. Prints one "MP {json}" line.
MP_WORKER = r"""
import json, sys, time
import numpy as np
import torch
pid, port, walk, argv = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4:]
from mirror_maze_tpu_torch import __main__ as cli, kernels
from mirror_maze_tpu_torch.parallel import initialize_multihost
from mirror_maze_tpu_torch.parallel.multiplayer import (make_multiplayer_engine,
                                                         make_position_exchange)
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import FrameInputs

args = cli.build_parser().parse_args(["play"] + argv)
dev = cli._device(args)
assert initialize_multihost(f"localhost:{port}", 2, pid, timeout_s=120) == 2
cfg, scene, noise = cli._build_world(args)
mdev, init_fn, step_fn = make_multiplayer_engine(cfg, me=pid, scene=scene, device=dev)
exchange = make_position_exchange()
step_fn(init_fn(0), FrameInputs.idle())          # first-use costs, on a scratch state
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
sync()
kernels.reset_launches()
st = init_fn(0)
t0 = time.perf_counter()
for _ in range(walk):
    st, frame = step_fn(st, FrameInputs.make(w=pid == 1))
positions = exchange(st.cam_center)
cam = st.cam_center.cpu().tolist()
st, frame = step_fn(st, FrameInputs.idle())
frame = frame.cpu().numpy()
ms = (time.perf_counter() - t0) * 1000.0 / (walk + 1)
launches = dict(kernels.launches)
out = dict(pid=pid, ms_per_frame=ms, launches=launches, cam=[float(c).hex() for c in cam],
           positions=[[float(c).hex() for c in row] for row in positions.cpu().tolist()],
           spheres=mdev.num_spheres, z=cam[2])
if pid == 0:
    # The same frames of a single-player run: the avatar must show.
    _, alone = run_scripted(upload_scene(scene, device=dev), cfg, n_frames=walk + 1)
    out["pixels_differing_from_single_player"] = int((alone != frame).any(axis=-1).sum())
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
    import contextlib
    import io
    import pty
    import re
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

    def want(n, **kw) -> dict:
        """The launches of n frames stepped: one tracer and one present each
        (or the counts given), none on the CPU."""
        counts = kw or {"tracer": n, "present": n}
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
                == want(1, tracer=batches)):
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
                ok = same and frames == 64 and launched == want(frames + len(argvs))
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
                and warm == want(1) and sess_launches == want(frames)):
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
        if not (same and counts == want(0, tracer=34, present_halo=34)):
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
                and final["error"] is None and counts == want(stepped + 1)):
            raise SystemExit("[serve] FAIL")

        # [multiplayer]: two player processes on the one device over gloo.
        t0 = time.perf_counter()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        procs = [subprocess.Popen([sys.executable, "-c", MP_WORKER, str(i), port, str(MP_WALK),
                                   *DRIVER_ARGS, *dev_args],
                                  cwd=tmp, env=env, stdout=subprocess.PIPE,
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
        log(f"[multiplayer] 2 players over gloo on {dev}, player 1 walks {MP_WALK} frames, "
            f"then 1 idle: ms/frame {res[0]['ms_per_frame']:.2f} / {res[1]['ms_per_frame']:.2f}"
            f" (player 0 / 1, exchange included); gathered positions == each player's "
            f"cam_center: {same_pos}; player 1 z {res[1]['z']:+.3f}; player 0's frame differs "
            f"from the single-player run's in {shows} pixels; launches {res[0]['launches']} / "
            f"{res[1]['launches']}; {time.perf_counter() - t0:.1f} s | {smi}")
        if not (same_pos and shows > 0 and res[1]["z"] > cfg.camera.spawn[2]
                and all(r["launches"] == want(MP_WALK + 1) for r in res)):
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
        if not (good and counts == want(n)):
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
        if not (good and counts == want(0, tracer=48 * a_batches)):
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
        if not (good and counts == want(0, tracer=4)):
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
SOAK_SCENES = 40
EXAMPLE_ARGS = ["--intersector", "pallas", "--size", "256", "--spp", "64"]
MP_DEMO_ARGS = ["--players", "3", "--frames", "24"]


def entry_phases(dev, smi: str) -> None:
    """The phases of the repository's own entry points on the port: the
    bench (``python -m mirror_maze_tpu_torch.bench``), its ``--validate`` and
    ``--sharded-bands``, the kernel exactness soak and the three examples.
    The bench and the examples run in subprocesses with no ``--device`` (the
    card; ``--device cpu`` where ``dev`` is the CPU, the rehearsal). Each
    phase prints its seconds; any failure ends the run with SystemExit."""
    import ast
    import re
    import shutil
    import tempfile

    import torch

    from mirror_maze_tpu_torch import bench, kernels
    from mirror_maze_tpu_torch.examples import cornell_box, mesh_gallery, multiplayer_demo
    from mirror_maze_tpu_torch.parallel.shard import make_sharded_scan_engine
    from mirror_maze_tpu_torch.runtime.state import FrameInputs, init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, repeat_input
    from mirror_maze_tpu_torch.tools import soak_kernel
    from mirror_maze_tpu_torch.utils import imageio
    from _torch_tools import gif_frame_count

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    tmp = tempfile.mkdtemp(prefix="mm_entry_")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_all = time.perf_counter()

    def want(**counts) -> dict:
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
                and sub == counts == want(tracer=n, present=n)
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
                and sub == want(tracer=bands * n, present_halo=bands * n)):
            raise SystemExit("[bench-bands] FAIL")

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
        # is textured.
        expected = sum(len(r["bitwise"]) for r in recs) if on_card else 0
        if (fails or len(recs) != SOAK_SCENES or sum(counts.values()) != expected
                or set(counts) - {"tracer", "tracer_tex"}):
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
            if not (same and img.mean() > 1.0 and counts == want(tracer=-(-size // 64))):
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


def main() -> int:
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
    from mirror_maze_tpu_torch.runtime.step import make_scan_step
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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
    # the launch counts set to 0 just before and read just after.
    def drive(path, script=None):
        """Run ``path``'s configuration through its script (or another
        path's): (launch counts, last frame)."""
        cfg, scene = configs[path], scenes[path]
        sc = cfg.screen
        idle, walk, turn, idle2 = SCRIPTS[script or path]
        inputs = ([FrameInputs.idle()] * idle + [FrameInputs.make(w=True)] * walk
                  + [FrameInputs.make(mouse_dx=-27.0)] * turn + [FrameInputs.idle()] * idle2)
        run = make_scan_step(scene, cfg)
        run(init_state(cfg, seed=0, device=dev), inputs[:2])   # first-launch costs
        torch.cuda.synchronize()
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
        cfg_name = {"main": "interactive", "glass": "interactive + glass_prob 0.5",
                    "glass-scale": "scale + glass_prob 0.5",
                    "sky": "interactive + sky_strength 0.7"}.get(path, path)
        tag = path if script is None else f"{path} on {script}'s script"
        log(f"[{tag}] config_{cfg_name} {sc.width}x{sc.height} {sc.samples_per_pixel} spp, "
            f"{n_frames} frames ({idle} idle, {walk} walk, {turn} turn, {idle2} idle), "
            f"{rays} rays/frame: {ms_frame:.3f} ms/frame, "
            f"{rays / ms_frame / 1e3:.2f} Mrays/s (host wall {wall:.2f} s), checksum "
            f"{checksum}, camera moved {moved:.3f}, launches {counts} | {smi}")
        display = frame.to(torch.float32)
        if not (tuple(frame.shape) == (sc.height, sc.width, 3) and frame.dtype == torch.uint8
                and float(display.mean()) > 1.0 and moved > 0.0
                and torch.isfinite(st.screen).all()):
            raise SystemExit(f"[{path}] FAIL: frame blank or malformed, or the camera "
                             "did not move")
        if counts.get("tracer") != n_frames or counts.get("present") != n_frames:
            raise SystemExit(f"[{path}] FAIL: launches {counts} != {n_frames} frames each")
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
    log(f"[adaptive] config_interactive + adaptive_refresh, {epoch - 1} + 9 idle frames (the "
        f"queue of {asc.total_chunks} chunks wraps on frame {epoch}): queue still a permutation "
        f"{is_perm}, {moved_share:.4f} of its places changed at the wrap, "
        f"{a_start.elapsed_time(a_end) / 9:.3f} ms/frame over the last 9, launches {counts} | {smi}")
    if not (is_perm and moved_share > 0.5 and float(aframe.float().mean()) > 1.0):
        raise SystemExit("[adaptive] FAIL: the queue was not reordered at the wrap")
    if counts != {"tracer": epoch + 8, "present": epoch + 8}:
        raise SystemExit(f"[adaptive] FAIL: launches {counts}")
    del ast, aframe, before

    # The row-band engine: the screen cut into bands, every band on this
    # one card. Camera against the single engine's, the kernel present
    # against the plain halo blur, launches counted.
    def drive_bands(tag, path, n_bands):
        cfg, scene = configs[path], scenes[path]
        sc = cfg.screen
        idle, walk, turn, idle2 = SCRIPTS.get(tag, SCRIPTS["glass"])
        inputs = ([FrameInputs.idle()] * idle + [FrameInputs.make(w=True)] * walk
                  + [FrameInputs.make(mouse_dx=-27.0)] * turn + [FrameInputs.idle()] * idle2)
        devices = [dev] * n_bands
        init_fn, scan_fn = shard.make_sharded_scan_engine(cfg, devices)
        scan_fn(scene, init_fn(0), inputs[:2])                  # first-launch costs
        torch.cuda.synchronize()
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
            f"plain halo blur's bitwise {screens}, launches {counts} | {smi}")
        if not (tuple(frame.shape) == (sc.height, sc.width, 3) and frame.dtype == torch.uint8
                and float(frame.float().mean()) > 1.0 and camera and screens
                and torch.equal(frame, pframe)):
            raise SystemExit(f"[{tag}] FAIL: frame malformed, or the camera or the present "
                             "disagrees")
        if counts != {"tracer": n_bands * n_frames, "present_halo": n_bands * n_frames}:
            raise SystemExit(f"[{tag}] FAIL: launches {counts}")
        launches[tag] = counts

    drive_bands("bands", "main", 2)
    drive_bands("bands-4k", "scale", 4)

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
        if counts != {lib: sc.height // GALLERY_ROWS}:
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
    jnp_phases(dev, smi)

    # 9. The drivers: the CLI, terminal play, the HTTP server, multiplayer
    # and the offline commands, at full width; each phase prints its seconds
    # and the launches counted around it.
    driver_phases(dev, smi)

    # 10. The repository's own entry points on the port: the bench, its
    # --validate and --sharded-bands, the soak and the examples.
    entry_phases(dev, smi)

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
    log(json.dumps({"kernels": kern}))
    count = torch.cuda.device_count()
    if count != 1:
        raise SystemExit(f"[device] FAIL: {count} cards visible, the smoke drives one")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
