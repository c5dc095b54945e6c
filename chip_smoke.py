#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``mirror_maze_tpu_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch version on the card, drives
the port's main path — ``config_interactive`` (10x10 maze, 1920x1080,
64 spp, 8 mirror bounces) through ``make_scan_step`` — and checks the
engine's scripted run against the committed golden frame. Every phase
prints one line; any failure exits non-zero. The last two lines are the
``{"kernels": [...]}`` summary and ``{"ok": true, "device": {...}}``.

Needs a CUDA card: without one it exits 2 and prints no result. It uses
the first visible card only. Imports torch and numpy, the port and the
port's JAX-free test helpers (``tests/_torch_tools.py``), nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit):
HBM_BYTES_PER_S = 3.35e12
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


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call on the card: CUDA events around ``reps`` calls
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The main path's script: idle, walking, turning, idle frames.
IDLE, WALK, TURN = 64, 30, 10


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
        from _torch_tools import golden_config, golden_script
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.render.fused_tracer import (
        trace_paths_fused,
        trace_paths_plain,
    )
    from mirror_maze_tpu_torch.render.pipeline import frame_rays
    from mirror_maze_tpu_torch.render.present import present, present_plain
    from mirror_maze_tpu_torch.render.scenebuf import upload_scene
    from mirror_maze_tpu_torch.render.scheduler import (
        chunk_origin_xy,
        chunk_pixels,
        sort_window_morton,
        take_chunks,
    )
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.runtime.loop import run_scripted
    from mirror_maze_tpu_torch.runtime.state import FrameInputs, init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step
    from mirror_maze_tpu_torch.scene import build_scene

    # The plain versions' comparison paths run in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
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
    log(f"[build] tracer, present built and loaded in {time.perf_counter() - t0:.1f} s")

    cfg = P.NAMED_CONFIGS["interactive"]()
    sc = cfg.screen
    entries = {}

    # 3. Present kernel vs its plain version: bitwise, 1080p chunk-major.
    gen = torch.Generator(device=dev).manual_seed(0)
    screen = torch.rand((sc.total_chunks, sc.pixels_per_chunk * 3), generator=gen,
                        device=dev) * 1.2 - 0.1
    present_err = 0.0
    for quantize in (True, False):
        got = present(screen, sc, quantize)
        want = present_plain(screen, sc, quantize)
        torch.cuda.synchronize()
        present_err = max(present_err, float((got - want).abs().max()))
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = int((got != want).sum())
            raise SystemExit(f"[present] FAIL quantize={quantize}: {bad} floats differ")
        log(f"[present] kernel == plain bitwise, quantize={quantize}, "
            f"shape {tuple(screen.shape)}")
    n_bytes = 2 * screen.numel() * 4
    entries["present"] = dict(
        max_abs_err=present_err,
        ms=time_ms(lambda: present(screen, sc, True), 50),
        plain_ms=time_ms(lambda: present_plain(screen, sc, True), 5),
        bound_ms=max(n_bytes / HBM_BYTES_PER_S, 10 * screen.numel() / FP32_OPS_PER_S) * 1e3,
        bound_by="bytes",
    )

    # 4. Tracer kernel vs its plain version on frame 1's rays of the main path.
    scene = upload_scene(build_scene(cfg.maze), device=dev)
    st = init_state(cfg, seed=0, device=dev)
    ids, _ = take_chunks(st.perm, st.cursor, sc.effective_chunks_per_frame)
    ids = sort_window_morton(ids, sc)
    _, key = prng.split(st.key)
    fkey = prng.fold_in(key, 1)
    pixels = chunk_pixels(chunk_origin_xy(ids, sc), sc.chunk_width)
    ori, dirs, seed = frame_rays(st.camera(cfg), pixels, fkey, cfg)
    tc = cfg.tracer
    block = tc.block_rows
    got = trace_paths_fused(scene.planes, scene.mode_counts, ori, dirs, seed, tc, block)
    stats = {}
    want = trace_paths_plain(scene.planes, scene.mode_counts, ori, dirs, seed, tc, block,
                             stats=stats)
    torch.cuda.synchronize()
    close = torch.isclose(got, want, rtol=1e-5, atol=1e-6).all(dim=1)
    frac = float(close.float().mean())
    exact = float((got == want).all(dim=1).float().mean())
    mean_rel = abs(float(got.mean()) - float(want.mean())) / max(abs(float(want.mean())), 1e-12)
    err = float((got - want).abs().max())
    ok = torch.isfinite(got).all() and frac >= 0.99 and mean_rel <= 1e-3
    log(f"[tracer] {ori.shape[0]} rays, {scene.num_planes} planes "
        f"(modes {scene.mode_counts}), B={block * 128}: {frac:.6f} of rays within "
        f"rtol 1e-5 (need >= 0.99), {exact:.6f} bitwise, mean light rel diff "
        f"{mean_rel:.2e} (need <= 1e-3), max abs diff {err:.3e}, "
        f"{stats['ray_segments']} live ray-segments")
    if not ok:
        raise SystemExit("[tracer] FAIL: kernel disagrees with its plain version")
    n0, n1, n2 = scene.mode_counts
    # Operations per live (ray, segment): 16 per plane for the plane test
    # (two 3-term dots, the IEEE reciprocal and multiply, compare, select)
    # plus 16 per tested edge (two 3-term dots, the affine s, two compares).
    ops = stats["ray_segments"] * 16 * (scene.num_planes + (n0 + n1) + n0)
    n_bytes = (ori.numel() + dirs.numel() + got.numel()) * 4
    entries["tracer"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: trace_paths_fused(scene.planes, scene.mode_counts, ori, dirs,
                                             seed, tc, block), 5),
        plain_ms=time_ms(lambda: trace_paths_plain(scene.planes, scene.mode_counts, ori,
                                                   dirs, seed, tc, block), 1),
        bound_ms=max(ops / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if ops / FP32_OPS_PER_S > n_bytes / HBM_BYTES_PER_S
        else "bytes",
    )

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

    # 6. The main path: config_interactive at full width, scripted.
    inputs = ([FrameInputs.idle()] * IDLE + [FrameInputs.make(w=True)] * WALK
              + [FrameInputs.make(mouse_dx=-27.0)] * TURN + [FrameInputs.idle()] * IDLE)
    run = make_scan_step(scene, cfg)
    warm = init_state(cfg, seed=0, device=dev)
    run(warm, inputs[:2])                       # first-launch costs out of the timing
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
    log(f"[main] config_interactive {sc.width}x{sc.height} {sc.samples_per_pixel} spp, "
        f"{n_frames} frames ({IDLE} idle, {WALK} walk, {TURN} turn, {IDLE} idle), "
        f"{rays} rays/frame: {ms_frame:.3f} ms/frame, "
        f"{rays / ms_frame / 1e3:.2f} Mrays/s (host wall {wall:.2f} s), checksum "
        f"{checksum}, camera moved {moved:.3f}, launches {counts} | {smi}")
    display = frame.to(torch.float32)
    if not (tuple(frame.shape) == (sc.height, sc.width, 3) and frame.dtype == torch.uint8
            and float(display.mean()) > 1.0 and moved > 0.0
            and torch.isfinite(st.screen).all()):
        raise SystemExit("[main] FAIL: frame blank or malformed, or the camera did not move")
    if counts.get("tracer") != n_frames or counts.get("present") != n_frames:
        raise SystemExit(f"[main] FAIL: launches {counts} != {n_frames} frames each")

    kern = []
    for kname in ("tracer", "present"):
        e = entries[kname]
        kern.append(dict(name=kname, route="cuda", source=SOURCES[kname],
                         replaces=REPLACES[kname], launches=counts[kname],
                         max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
                         bound_ms=e["bound_ms"], bound_by=e["bound_by"], library_ms=None))
    log(json.dumps({"kernels": kern}))
    count = torch.cuda.device_count()
    if count != 1:
        raise SystemExit(f"[device] FAIL: {count} cards visible, the smoke drives one")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
