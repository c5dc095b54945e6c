#!/usr/bin/env python3
"""The present kernel's time on the card, by one fixed method.

    python3 time_present.py [--port DIR]

Times ``present`` of the port in DIR (default: the one beside this script;
a ``git archive`` of another commit unpacked there times that commit's
kernel by the same method) on the screens the driven paths give it: a
1920x1080 and a 3840x2160 screen without halos, and one band of each with
its halo rows (1080p cut into 2 bands, 4K into 4).

A row's time is the mean over REPS launches, each timed alone by CUDA
events with the L2 emptied of its data before it (L2_FLUSH_BYTES read, not
written) and queued on the card behind a spin of SPIN_CYCLES, so that the
host's time to launch it is not in the reading. Beside it stands the
back-to-back time: REPS launches replayed from one CUDA graph, where a
1080p screen (24.9 MB) is partly served from the 50 MB L2 and a 4K screen
(99.5 MB) is not. The bound is one read of the screen (and halo rows) and
one write of the result over the card's memory rate.

Prints one JSON line per row, then the card's name and power limit. Needs
a CUDA card; imports torch and the port, nothing of JAX. ``chip_smoke.py``
times its present rows with the same functions.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
L2_FLUSH_BYTES = 128 << 20   # read between launches to empty the 50 MB L2
SPIN_CYCLES = 1_000_000      # ~0.5 ms at 1.98 GHz: longer than the host takes to launch
REPS = 20


def time_ms(fn, reps: int, graph: bool = False) -> float:
    """Mean ms per call on the card: CUDA events around ``reps`` calls
    after one warm-up call. With ``graph`` the calls are captured into one
    CUDA graph and the replay is timed: the card's time for a kernel so
    short that the host cannot launch it as fast as it runs."""
    import torch

    def run():
        for _ in range(reps):     # each result is dropped, so its memory is reused
            fn()

    fn()
    if graph:
        torch.cuda.synchronize()
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        run = captured.replay
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int) -> float:
    """Mean ms of one call on the card with the L2 emptied of its data:
    before each call L2_FLUSH_BYTES are read (not written, so that no dirty
    line of the flush is written back during the call), then the card spins
    for SPIN_CYCLES while the host queues the call, and CUDA events time the
    call alone."""
    import torch

    scrub = torch.ones(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        scrub.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def time_present(fn, n_bytes: int) -> dict:
    """A present row: ``ms`` with the L2 emptied before each launch (the
    row's time), ``warm`` back to back from a CUDA graph, and the bytes
    bound of ``n_bytes`` moved."""
    return dict(ms=time_cold_ms(fn, REPS), warm=time_ms(fn, REPS, graph=True),
                bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the directory that holds the mirror_maze_tpu_torch to time")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_present: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.port))
    import dataclasses

    from mirror_maze_tpu_torch.config import ScreenConfig
    from mirror_maze_tpu_torch.parallel import shard
    from mirror_maze_tpu_torch.render.present import present

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def screen(sc, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand((sc.total_chunks, sc.pixels_per_chunk * 3), generator=gen,
                          device=dev) * 1.2 - 0.1

    for row, (w, h, n_bands) in (("present", (1920, 1080, 1)), ("present@4k", (3840, 2160, 1)),
                                 ("present-halo", (1920, 1080, 2)),
                                 ("present-halo@4k", (3840, 2160, 4))):
        sc = ScreenConfig(width=w, height=h)
        if n_bands == 1:
            s = screen(sc, 0)
            got = time_present(lambda: present(s, sc, True), 2 * s.numel() * 4)
        else:
            band = dataclasses.replace(sc, height=h // n_bands)
            bands = list(screen(sc, 1).chunk(n_bands))
            tops, bots = shard._exchange_halo_rows(bands, band)
            b, t, u = bands[1], tops[1], bots[1]
            got = time_present(lambda: present(b, band, True, t, u),
                               (2 * b.numel() + t.numel() + u.numel()) * 4)
        print(json.dumps(dict(row=row, port=os.path.abspath(args.port), **got)), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
