"""Benchmark harness of the port (counterpart of the repository's
``bench.py``): steady-state frame rate and ray throughput at the north-star
operating point (BASELINE.md: 1080p, 8 mirror bounces, 64 spp progressive
refresh, against the reference's implied 47.2 M primary rays/s).

    python -m mirror_maze_tpu_torch.bench [--preset scale] [--device cpu] ...
    python -m mirror_maze_tpu_torch.bench --validate

Runs on the CUDA card unless ``--device cpu`` is given (no fallback). Prints
ONE JSON line on stdout with ``bench.py``'s keys and meanings, plus
``launch_ms`` and ``setup_s``; the kernel launches of the run go to stderr on
an earlier line, as the CLI commands print them. ``--validate`` renders one
deterministic frame with every backend and prints ``bench.py --validate``'s
JSON instead.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

# Reference implied operating point: 786,432 primary rays/frame at 60 fps
# = 47.2 Mrays/s (BASELINE.md, derived from main.rs:646-650,760).
BASELINE_MRAYS = 47.2

# --validate's backends, brute (the reference) first.
VALIDATE_BACKENDS = ("brute", "pallas", "bvh", "exact")


def build_parser() -> argparse.ArgumentParser:
    """bench.py's flags, with its names and defaults, plus ``--device``."""
    p = argparse.ArgumentParser(prog="python -m mirror_maze_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spp", type=int, default=64,
                   help="samples per refreshed pixel (reference: 64)")
    p.add_argument("--mirror-limit", type=int, default=8)
    p.add_argument("--bounce-limit", type=int, default=5)
    p.add_argument("--maze", type=int, default=10)
    p.add_argument("--frames", type=int, default=60,
                   help="frames per timed call of make_scan_step")
    p.add_argument("--launches", type=int, default=3,
                   help="timed calls of --frames each")
    p.add_argument("--intersector", type=str, default=None,
                   help="override backend: brute | bvh | exact | pallas (the fused "
                        "CUDA tracer kernel)")
    p.add_argument("--lane-chunk", type=int, default=None,
                   help="sets TracerConfig.lane_chunk, as bench.py does; the port's "
                        "tracer has no lane chunks, so it changes nothing, bitwise or "
                        "in time")
    p.add_argument("--block-rows", type=int, default=None,
                   help="override TracerConfig.block_rows (B = 128 x rows: ray i's "
                        "random stream is seeded by (seed, i // B, i %% B), so it "
                        "changes the image)")
    p.add_argument("--glass-prob", type=float, default=0.0, dest="glass_prob",
                   help="fraction of mirror walls converted to GLASS panes (measures "
                        "the dielectric stage's cost; 0 = reference parity)")
    p.add_argument("--sort-window", type=int, default=None, choices=(0, 1),
                   help="override ScreenConfig.sort_chunk_window (default: on)")
    p.add_argument("--preset", type=str, default=None,
                   help="named config (v0|bvh|fuzzy|interactive|scale|reference); "
                        "overrides the geometry flags")
    p.add_argument("--sharded-bands", type=int, default=None,
                   help="run the row-band engine (parallel/shard.py "
                        "make_sharded_scan_engine) with n bands instead of the single "
                        "engine; every band on the --device")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="wrap the timed calls in a torch.profiler trace "
                        "(utils/profiling.trace) written to DIR/bench_trace.json")
    p.add_argument("--validate", action="store_true",
                   help="instead of timing, render one deterministic frame with brute, "
                        "pallas (the fused kernel), bvh and exact and hold each against "
                        "brute: bvh and exact bitwise, pallas on all but a vanishing "
                        "share of pixels (exact ties); prints its JSON")
    p.add_argument("--device", default=None,
                   help="device to run on (default: the CUDA card; fails without one. "
                        "'cpu' runs the plain PyTorch versions of the kernels)")
    return p


def block_rows_for(group_meta) -> int:
    """bench.py's block size by the largest tile count of any group: every
    group in one tile -> 96, a few tiles -> 32, many -> 24. The port's
    groups and tiles are the JAX package's packed groups (one a test mode,
    tiles of PLANE_TILE)."""
    n_tiles = max(n for _, _, n in group_meta)
    return 96 if n_tiles == 1 else (32 if n_tiles <= 4 else 24)


def build_bench_setup(args):
    """(cfg, host scene, device scene) for the bench operating point, as
    bench.py build_bench_setup; ``args`` is the parsed bench namespace (or
    any object with the same attributes), the scene is uploaded to
    ``args.device`` (None = the CUDA card)."""
    from .config import (
        NAMED_CONFIGS,
        CameraConfig,
        EngineConfig,
        MazeConfig,
        ScreenConfig,
        TracerConfig,
    )
    from .render import upload_scene
    from .scene import build_scene

    if args.preset:
        cfg = NAMED_CONFIGS[args.preset]()
    else:
        # Keep the spawn INSIDE the world: the default (-5, 0, -45) fits
        # mazes >= 10x10 but sits outside smaller worlds, where the frames
        # are black. Move it only when outside, to the same half-cell-inset
        # position the 10x10 default has.
        maze = MazeConfig(width=args.maze, height=args.maze, glass_prob=args.glass_prob)
        cam = CameraConfig()
        if abs(cam.spawn[2]) >= maze.world_half_extent:
            spawn_z = -(maze.world_half_extent - maze.cell_size / 2.0)
            cam = CameraConfig(spawn=(-5.0, 0.0, spawn_z))
        cfg = EngineConfig(
            maze=maze,
            camera=cam,
            tracer=TracerConfig(bounce_limit=args.bounce_limit,
                                mirror_limit=args.mirror_limit),
            screen=ScreenConfig(width=args.width, height=args.height,
                                samples_per_pixel=args.spp, sort_chunk_window=True),
        )
    if args.intersector:
        cfg = cfg.replace(intersector=args.intersector)
    if args.block_rows:
        cfg = cfg.replace(tracer=dataclasses.replace(cfg.tracer, block_rows=args.block_rows))
    if args.lane_chunk:
        cfg = cfg.replace(tracer=dataclasses.replace(cfg.tracer, lane_chunk=args.lane_chunk))
    if args.sort_window is not None:
        cfg = cfg.replace(screen=dataclasses.replace(
            cfg.screen, sort_chunk_window=bool(args.sort_window)))

    scene = build_scene(cfg.maze)
    dev_scene = upload_scene(scene, device=getattr(args, "device", None))
    if args.block_rows is None and args.preset is None:
        cfg = cfg.replace(tracer=dataclasses.replace(
            cfg.tracer, block_rows=block_rows_for(dev_scene.group_meta)))
    return cfg, scene, dev_scene


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def run_bench(args):
    """The timed run: (the JSON result, the final uint8 frame [H, W, 3] on
    the host, the kernel launches of the run by name)."""
    from . import kernels
    from .device import resolve_device
    from .runtime.state import FrameInputs, init_state
    from .runtime.step import make_scan_step, repeat_input

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    before = collections.Counter(kernels.launches)
    t0 = time.perf_counter()
    cfg, scene, dev_scene = build_bench_setup(args)
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    if args.sharded_bands:
        from .parallel.shard import make_sharded_scan_engine

        n_bands = args.sharded_bands
        init_fn, scan_fn = make_sharded_scan_engine(cfg, devices=[dev] * n_bands)
        state = init_fn(seed=0)
        step_n = lambda st, inp: scan_fn(dev_scene, st, inp)  # noqa: E731
        # Each band pops its own window (shard.py _band_screen_cfg).
        chunks_per_frame = n_bands * max(1, cfg.screen.effective_chunks_per_frame // n_bands)
    else:
        step_n = make_scan_step(dev_scene, cfg)
        state = init_state(cfg, seed=0, device=dev)
        chunks_per_frame = cfg.screen.effective_chunks_per_frame
    idle_n = repeat_input(FrameInputs.idle(), args.frames)

    # A host fetch of a value of the final frame: it waits for every frame
    # before it.
    def force(frame) -> float:
        return float(frame.sum())

    # Warm-up call (forced): the kernels' nvcc build when the cache is cold,
    # plus the first --frames frames.
    t0 = time.perf_counter()
    state, frame = step_n(state, idle_n)
    force(frame)
    compile_s = time.perf_counter() - t0

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from .utils.profiling import trace

        os.makedirs(args.profile, exist_ok=True)
        profile_ctx = trace(os.path.join(args.profile, "bench_trace.json"))
    # launch_ms: on the card each call's CUDA-event time (read after the
    # fetch); on the CPU, where every op ends before the call returns, its
    # host time.
    events, host_ms = [], []
    t0 = time.perf_counter()
    with profile_ctx:
        for _ in range(args.launches):
            t1 = time.perf_counter()
            if on_card:
                events.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
                events[-1][0].record()
            state, frame = step_n(state, idle_n)
            if on_card:
                events[-1][1].record()
            host_ms.append((time.perf_counter() - t1) * 1e3)
        checksum = force(frame)
    dt = time.perf_counter() - t0
    launch_ms = [s.elapsed_time(e) for s, e in events] if on_card else host_ms

    n_total = args.frames * args.launches
    fps = n_total / dt
    rays_per_frame = (chunks_per_frame * cfg.screen.pixels_per_chunk
                      * cfg.screen.samples_per_pixel)
    mrays = rays_per_frame * fps / 1e6
    launches = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v - before.get(k, 0)}
    result = {
        "metric": "primary Mrays/s, progressive mirror-maze path tracing "
                  f"({cfg.screen.width}x{cfg.screen.height}, "
                  f"{cfg.tracer.mirror_limit} mirror bounces, "
                  f"{cfg.screen.samples_per_pixel} spp/refresh)",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "frame_ms": round(1000.0 * dt / n_total, 3),
        "fps": round(fps, 2),
        "rays_per_frame": rays_per_frame,
        "compile_s": round(compile_s, 1),
        "frame_checksum": round(checksum, 1),
        "backend": dev.type,
        "device": _device_name(dev),
        "intersector": cfg.intersector,
        "sharded_bands": args.sharded_bands,
        "planes": scene.num_planes,
        # the plane rows the tracer holds (degenerate rows filtered)
        "kernel_planes": int(dev_scene.plane_table.shape[0]),
        "launch_ms": launch_ms,
        "setup_s": setup_s,
    }
    return result, frame.cpu().numpy(), launches


def validate_config():
    """--validate's fixed configuration (bench.py _validate): a 16x16 maze
    (several tiles), 128x96 at 1 spp, no jitter and one diffuse segment
    after mirror chains, so that every backend computes the same light."""
    from .config import CameraConfig, EngineConfig, MazeConfig, ScreenConfig, TracerConfig

    return EngineConfig(
        maze=MazeConfig(width=16, height=16),
        tracer=TracerConfig(bounce_limit=1, mirror_limit=6, jitter=0.0, block_rows=16),
        camera=CameraConfig(spawn=(-5.0, 0.0, -75.0)),
        screen=ScreenConfig(width=128, height=96, samples_per_pixel=1),
    )


def validate_frames(device=None) -> dict:
    """--validate's frame [H, W, 3] (tone-mapped float32, on the host) of
    each backend."""
    from .device import resolve_device
    from .ops import prng
    from .render import make_camera, render_full_frame, upload_scene
    from .scene import build_scene

    dev = resolve_device(device)
    base = validate_config()
    scene = upload_scene(build_scene(base.maze), device=dev)
    cam = make_camera(base.camera, base.screen.width / base.screen.height, dev)
    key = prng.PRNGKey(0, device=dev)
    return {b: render_full_frame(scene, cam, key, base.replace(intersector=b)).cpu().numpy()
            for b in VALIDATE_BACKENDS}


def validate(device=None) -> dict:
    """bench.py --validate's JSON on ``device``, under the JAX package's CPU
    gates on the CPU and on the card alike (the card computes every backend
    in full float32 and IEEE division, as the CPU does): bvh and exact equal
    brute bitwise; the fused kernel differs on fewer than 1e-3 of the pixels
    and by less than 1e-3 on the mean (exactly tied nearest hits sum their
    properties in the kernel, where the jnp tracer picks one)."""
    from .device import resolve_device

    dev = resolve_device(device)
    frames = validate_frames(dev)
    ref = frames["brute"]
    if not (np.isfinite(ref).all() and ref.max() > 0.0):
        raise RuntimeError("the brute frame is degenerate")
    result = {
        "metric": "cross-backend max |pallas - brute| (deterministic light)",
        "unit": "tone-mapped radiance (ref in [0, ~1])",
        "backend": dev.type,
        "device": _device_name(dev),
        "pixels": int(ref.shape[0] * ref.shape[1]),
        "ok": True,
    }
    for backend in ("pallas", "bvh", "exact"):
        d = np.abs(frames[backend] - ref)
        stats = {
            "max": float(d.max()),
            "mean": float(d.mean()),
            "p999": float(np.quantile(d, 0.999)),
            "frac_gt_0.05": float((d > 0.05).mean()),
            "frac_nonzero": float((d > 0.0).mean()),
        }
        if backend == "pallas":
            ok = stats["frac_nonzero"] < 1e-3 and stats["mean"] < 1e-3
            result["value"] = round(stats["max"], 9)
        else:
            ok = stats["max"] == 0.0
        result[backend] = stats
        result["ok"] = result["ok"] and ok
    return result


def main(argv=None) -> int:
    from .device import resolve_device

    p = build_parser()
    args = p.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e} (on the command line: --device cpu)") from None
    if args.validate:
        # The check runs ONE fixed configuration; any other flag would be
        # silently ignored ("--validate --preset scale" does NOT validate
        # scale). Only the device may be chosen.
        ignored = [name for name, val in sorted(vars(args).items())
                   if name not in ("validate", "device") and val != p.get_default(name)]
        if ignored:
            p.error(f"--validate runs a fixed configuration; remove {ignored}")
        result = validate(args.device)
        print(json.dumps(result))
        return 0 if result["ok"] else 1
    result, _, launches = run_bench(args)
    n = args.frames * (1 + args.launches)
    print(f"bench: {n} frames stepped ({args.frames} warm-up); kernel launches {launches}",
          file=sys.stderr, flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
