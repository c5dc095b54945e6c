"""The traced window: torch.profiler over the window, the benchmark's own
spans around its calls into the port (``pb.window``, ``pb.step``,
``pb.fetch``), and the reduction of the device timeline to what the
per-layer metrics read.

Device operations are the profiler's kernel, memcpy and memset records.
``busy_s`` is the length of their union inside the window; ``window_s``
the window's length; an idle gap is a stretch of the window with no device
operation, named by the benchmark span the host was in at its middle
(``harness`` outside every span). ``by_kernel`` gives every kernel that ran
in the window, by its name cut to 120 characters, its device seconds and
launches, so that a metric reads any kernel's time by a part of its name.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACER = "trace_kernel"
HOST_COPIES = ("HtoD", "DtoH")


def start(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def span(name: str):
    return torch.profiler.record_function(f"pb.{name}")


def nothing():
    return contextlib.nullcontext()


def _ns(e, what: str) -> int:
    """An event's start or duration in ns, whichever the torch build names."""
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")() * 1000)


def _kind(e, name: str) -> str:
    """kernel, gpu_memcpy, gpu_memset or gpu_user_annotation for a record
    on the device; user_annotation or cpu_op on the host."""
    on_device = "CUDA" in str(e.device_type())
    if name.startswith("pb."):
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def _events(prof):
    """(name, kind, start ns, end ns) of every record of the profile."""
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start")
        yield name, _kind(e, name), start, start + _ns(e, "duration")


def union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(records: list, frames: int, top: int = 10) -> dict:
    """What the per-layer metrics read of a window's records, (name, kind,
    start ns, end ns)."""
    spans = [r for r in records if r[1] == "user_annotation" and r[0].startswith("pb.")]
    windows = [r for r in spans if r[0] == "pb.window"]
    if not windows:
        return dict(records=len(records))
    w0, w1 = windows[0][2], windows[0][3]
    ops = [r for r in records if r[1] in DEVICE_OPS and r[3] > w0 and r[2] < w1]
    clipped = [(max(a, w0), min(b, w1)) for _, _, a, b in ops]
    busy = union(clipped)
    busy_ns = sum(b - a for a, b in busy)
    by_name = defaultdict(float)
    for name, _, a, b in ops:
        by_name[name[:120]] += (b - a) * 1e-9
    kernels = [r for r in ops if r[1] == "kernel"]
    by_kernel = {}
    for name, _, a, b in kernels:
        k = by_kernel.setdefault(name[:120], dict(seconds=0.0, launches=0))
        k["seconds"] += (b - a) * 1e-9
        k["launches"] += 1
    tracer = [r for r in kernels if TRACER in r[0]]
    glue = [r for r in ops if not (r[1] == "kernel" and TRACER in r[0])
            and not any(c in r[0] for c in HOST_COPIES)]
    host = sorted((a, b, name[3:]) for name, _, a, b in spans if name != "pb.window")
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            mid = (edge + a) / 2
            i = bisect.bisect_right(starts, mid) - 1
            where = host[i][2] if i >= 0 and host[i][1] > mid else "harness"
            gaps[where] += (a - edge) * 1e-9
        edge = max(edge, b)
    kinds = defaultdict(int)
    for r in records:
        kinds[r[1]] += 1
    return dict(
        records=dict(kinds), window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, frames=frames,
        kernels=len(kernels), tracer_launches=len(tracer),
        tracer_s=sum(b - a for _, _, a, b in tracer) * 1e-9,
        glue_s=sum(b - a for _, _, a, b in glue) * 1e-9, by_kernel=by_kernel,
        breakdown=dict(
            device_ops=[[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
            idle_gaps=[[n, s] for n, s in sorted(gaps.items(), key=lambda x: -x[1])[:top]]))


def stop(prof, frames: int) -> dict:
    prof.stop()
    return reduce(list(_events(prof)), frames)
