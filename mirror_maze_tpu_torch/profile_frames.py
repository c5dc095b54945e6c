"""Where a frame's time goes on the card: the port's main path under
torch.profiler.

    python -m mirror_maze_tpu_torch.profile_frames [--frames 16] [--trace out.json]

Runs ``config_interactive`` (1920x1080, 64 spp) for a few warm-up frames,
then ``--frames`` idle frames through ``make_scan_step`` under the profiler,
and prints one JSON line: ms/frame on the host clock (ending in a
synchronize), device busy ms/frame (the sum of CUDA kernel times), the
device's idle share, and the kernels by total device time. ``--trace``
writes the chrome trace. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None, help="chrome trace output path")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .config import config_interactive
    from .render.scenebuf import upload_scene
    from .runtime.state import FrameInputs, init_state
    from .runtime.step import make_scan_step
    from .scene import build_scene

    if not torch.cuda.is_available():
        raise SystemExit("profile_frames needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = config_interactive()
    scene = upload_scene(build_scene(cfg.maze))
    run = make_scan_step(scene, cfg)
    st, _ = run(init_state(cfg), [FrameInputs.idle()] * 4)
    torch.cuda.synchronize()
    inputs = [FrameInputs.idle()] * args.frames
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, frame = run(st, inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Kernel entries only (device-side events): the aten ops that launched
    # them carry the same time again.
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels)
    kernels.sort(key=dev_us, reverse=True)
    n = args.frames
    print(json.dumps({
        "card": card,
        "frames": n,
        "ms_per_frame_host": wall_ms / n,
        "device_busy_ms_per_frame": busy_us / 1e3 / n,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
        "kernels": [
            {"name": e.key[:80], "calls_per_frame": e.count / n,
             "ms_per_frame": dev_us(e) / 1e3 / n}
            for e in kernels[:args.top]
        ],
        "launches_per_frame": sum(e.count for e in kernels) / n,
    }))


if __name__ == "__main__":
    main()
