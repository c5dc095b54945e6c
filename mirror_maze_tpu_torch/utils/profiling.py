"""Profiling and observability (counterpart of the JAX package's
``utils/profiling.py``): ``span``, the program's own spans at its layer
boundaries, summed per name into ``totals()`` and on torch.profiler's
timeline while it records; ``trace``, a ``torch.profiler`` capture;
``device_memory_stats``; the fused tracer's ``tracer_segment_histogram``;
and the port's own ``warp_lane_share`` and ``sass_loops``.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time

import numpy as np
import torch
from torch.autograd import _profiler_enabled

from ..render.fused_tracer import LANES, WARP, trace_paths_fused


class span:
    """A span of the program's host work, as a context manager: on leaving
    it, its count, seconds and self seconds (its seconds less those of the
    spans closed inside it on the same thread) are added to the process's
    totals under ``name`` (``totals()``), and ``seconds`` holds its
    duration. While torch.profiler records, it is also a host record
    ``mm.<name>`` on the profiler's timeline, beside the device's records:
    an operator's record (kineto's ``cpu_op``), not a ``record_function``
    annotation, which would also lay a range over the device's timeline
    that a reader of its operations would take for one. Spans wrap host
    calls only: one inside a captured CUDA graph body would run at the
    capture and never on a replay."""

    __slots__ = ("name", "seconds", "children", "_t0", "_record")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self.children = 0.0     # seconds of the spans closed inside it on its thread
        self._record = None

    def __enter__(self) -> "span":
        _open_spans().append(self)
        if _profiler_enabled():
            self._record = torch._C._profiler._RecordFunctionFast(f"mm.{self.name}")
            self._record.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
        stack = _open_spans()
        stack.pop()
        if stack:
            stack[-1].children += self.seconds
        with _lock:
            entry = _totals.setdefault(self.name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += self.seconds
            entry[2] += self.seconds - self.children


_totals: dict = {}              # name -> [count, seconds, self seconds]
_lock = threading.Lock()
_threads = threading.local()    # .spans: the spans open on this thread, innermost last


def _open_spans() -> list:
    stack = getattr(_threads, "spans", None)
    if stack is None:
        stack = _threads.spans = []
    return stack


def totals() -> dict:
    """{name: {"count", "seconds", "self_seconds"}} of every span closed in
    this process since the start or the last ``reset_totals()``."""
    with _lock:
        return {k: dict(count=c, seconds=s, self_seconds=own)
                for k, (c, s, own) in _totals.items()}


def reset_totals() -> None:
    with _lock:
        _totals.clear()


@contextlib.contextmanager
def trace(path: str | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed block (the host,
    and the card's kernels where CUDA is available); yields the profiler,
    whose ``key_averages()`` the caller may read. With ``path`` the chrome
    trace is written there."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if path is not None:
        prof.export_chrome_trace(path)


def device_memory_stats(device=None) -> dict:
    """Live, peak and total bytes of a CUDA device (None = the current
    one), from ``torch.cuda.memory_stats`` and the device's properties."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device memory statistics are a CUDA device's, not {dev}")
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}


def warp_lane_share(segments_per_ray, warp: int = WARP) -> float:
    """The share of lanes alive per warp-segment when each warp of ``warp``
    consecutive rays keeps its rays until the last one dies (one thread per
    ray): the segments the rays lived, summed, over ``warp`` times the
    segments each warp runs (its longest ray's), summed. ``segments_per_ray``
    is [R] (``trace_paths_plain(..., stats=s)`` leaves it in
    ``s["segments_per_ray"]``); a last, partial warp counts its empty lanes
    as idle."""
    seg = torch.as_tensor(segments_per_ray).reshape(-1).to(torch.int64)
    seg = torch.nn.functional.pad(seg, (0, -seg.shape[0] % warp)).view(-1, warp)
    runs = int(seg.max(dim=1).values.sum())
    return float(seg.sum()) / (warp * runs) if runs else 0.0


def tracer_segment_histogram(scene, cfg, ori, dirs, seed: int = 7, rows_per_block: int = 8,
                             anchor=None) -> dict:
    """Per-block statistics of the fused tracer's bounce loop, from its
    diagnostics (``trace_paths_fused(..., return_block_segments=True)``): a
    block is ``rows_per_block * 128`` consecutive rays, the reference's
    program.

    Returns ``mean`` segments a block ran and ``histogram[k]``, the blocks
    that ran exactly k; ``mean_tiles`` evaluated per block and
    ``tiles_per_segment``, split into the primary segment (``tiles_seg0``),
    segments 1-2 and 3 on; and ``live_lane_frac``, the live rays entering the
    segments over block rays x segments."""
    seed_t = torch.tensor([seed], dtype=torch.int32, device=ori.device)
    _, diag = trace_paths_fused(scene, ori, dirs, seed_t, cfg.tracer, rows_per_block,
                                anchor=anchor, return_block_segments=True)
    segs, tiles, tiles0, tiles3, live = diag.cpu().numpy().astype(int)
    lanes = rows_per_block * LANES
    return {
        "mean": float(segs.mean()),
        "max_segments": cfg.tracer.max_segments,
        "histogram": np.bincount(segs, minlength=cfg.tracer.max_segments + 1).tolist(),
        "mean_tiles": float(tiles.mean()),
        "tiles_per_segment": float(tiles.sum() / max(segs.sum(), 1)),
        "tiles_seg0": float(tiles0.mean()),
        "tiles_per_segment_seg1_2": float(
            (tiles3 - tiles0).sum() / max(np.minimum(segs - 1, 2).sum(), 1)),
        "tiles_per_segment_seg3plus": float(
            (tiles - tiles3).sum() / max((segs - 3).clip(0).sum(), 1)),
        "live_lane_frac": float(live.sum() / max(segs.sum() * lanes, 1)),
    }


F32_OPS = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FSET")


def sass_loops(sass_text: str, function: str, max_len: int = 400,
               marker: str = "MUFU.RCP") -> list:
    """The loops of one kernel in ``cuobjdump -sass`` output (``function`` is
    its mangled name): one dict per backward branch whose body holds a
    ``marker`` instruction and at most ``max_len`` instructions, with the
    body's instructions (``insts``), markers (``records``), reciprocals
    (``rcp``), shared-memory loads (``lds``) and f32 arithmetic and compares
    (``f32``), by address. The default marker, MUFU.RCP (a reciprocal), is
    one per plane record of the general test; ``LDS.128`` is one per entry
    of the axis route's pass 1 in modes 1 and 2 (csrc/tracer.cu axis_min),
    whose loops hold no reciprocal."""
    body = sass_text.split(f"Function : {function}\n", 1)
    if len(body) < 2:
        return []
    body = body[1].split("Function : ", 1)[0]
    insts, labels = [], {}
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = len(insts)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            insts.append((int(m.group(1), 16), m.group(2).strip()))
    at = {addr: k for k, (addr, _) in enumerate(insts)}
    loops = []
    for k, (addr, text) in enumerate(insts):
        m = re.search(r"\bBRA\b[^`]*`?\(?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if not m:
            continue
        target = m.group(1)
        start = labels.get(target) if target.startswith(".L") else at.get(int(target, 16))
        if start is None or start > k or k - start >= max_len:
            continue
        ops = [t.split()[1] if t.startswith("@") else t.split()[0] for _, t in insts[start:k + 1]]
        rcp = sum(op.startswith("MUFU.RCP") for op in ops)
        records = sum(op.startswith(marker) for op in ops)
        if records:
            loops.append(dict(start=insts[start][0], end=addr, insts=len(ops), records=records,
                              rcp=rcp,
                              lds=sum(op.startswith("LDS") for op in ops),
                              f32=sum(op.split(".")[0] in F32_OPS for op in ops)))
    return loops
