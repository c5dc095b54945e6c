"""The program's own spans (utils/profiling.py ``span``): the totals a
span adds per name, its self time on its thread, its place on
torch.profiler's timeline while the profiler records, and the spans at
the layer boundaries a step and a kernel build pass through, all on the
CPU."""

import sys
import threading
import time

import pytest
import torch

import mirror_maze_tpu_torch as P
from mirror_maze_tpu_torch import kernels
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.runtime.state import FrameInputs, init_state
from mirror_maze_tpu_torch.runtime.step import make_scan_step
from mirror_maze_tpu_torch.scene import build_scene
from mirror_maze_tpu_torch.utils import profiling

TINY = P.EngineConfig(
    maze=P.MazeConfig(width=4, height=4),
    tracer=P.TracerConfig(bounce_limit=2, mirror_limit=2),
    camera=P.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
    screen=P.ScreenConfig(width=24, height=16, samples_per_pixel=2),
    intersector="brute")


@pytest.fixture
def fresh():
    """Empty totals before and after the test (they are the process's)."""
    profiling.reset_totals()
    yield
    profiling.reset_totals()


def test_nested_spans_count_total_and_self_time(fresh):
    with profiling.span("outer") as outer:
        time.sleep(0.02)
        for _ in range(2):
            with profiling.span("inner"):
                time.sleep(0.01)
    t = profiling.totals()
    assert set(t) == {"outer", "inner"}
    assert t["outer"]["count"] == 1 and t["inner"]["count"] == 2
    assert t["outer"]["seconds"] == outer.seconds >= 0.04
    assert t["inner"]["seconds"] >= 0.02
    # A span's self time is its time less its children's.
    assert t["outer"]["self_seconds"] == pytest.approx(
        t["outer"]["seconds"] - t["inner"]["seconds"], abs=1e-9)
    assert t["inner"]["self_seconds"] == t["inner"]["seconds"]


def test_spans_on_two_threads_keep_their_own_self_time(fresh):
    """A span open on one thread is no parent of a span on another."""
    started, release = threading.Event(), threading.Event()

    def other():
        with profiling.span("other"):
            started.set()
            release.wait(5.0)

    th = threading.Thread(target=other)
    th.start()
    assert started.wait(5.0)
    with profiling.span("here"):
        time.sleep(0.02)
    release.set()
    th.join(5.0)
    assert not th.is_alive()
    t = profiling.totals()
    assert t["here"]["self_seconds"] == t["here"]["seconds"] >= 0.02
    assert t["other"]["self_seconds"] == t["other"]["seconds"] >= t["here"]["seconds"]


def test_span_totals_lose_no_update_under_threads(fresh):
    """More threads than cores, switching often: every span is counted."""
    threads, each = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with profiling.span("busy"):
                    with profiling.span("leaf"):
                        pass
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(30.0)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    t = profiling.totals()
    assert t["busy"]["count"] == t["leaf"]["count"] == threads * each
    assert 0.0 <= t["busy"]["self_seconds"] <= t["busy"]["seconds"]


def test_reset_totals(fresh):
    with profiling.span("once"):
        pass
    assert profiling.totals()["once"]["count"] == 1
    profiling.reset_totals()
    assert profiling.totals() == {}
    with profiling.span("once"):
        pass
    assert profiling.totals()["once"]["count"] == 1


def _mm_events(prof) -> dict:
    """{name: [(start, end)]} of the ``mm.`` records of a profile."""
    out = {}
    for e in prof.events():
        if e.name.startswith("mm."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_spans_show_on_the_profilers_timeline_nested(fresh, tmp_path):
    """Host records nested as the spans were, of the operators' kind: a
    user annotation would also lay a range on the device's timeline."""
    import json

    path = str(tmp_path / "trace.json")
    with profiling.trace(path) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(64).sum()
    ev = _mm_events(prof)
    assert set(ev) == {"mm.outer", "mm.inner"}
    assert _inside(ev["mm.inner"][0], ev["mm.outer"][0])
    with open(path) as f:
        kinds = {e["name"]: e.get("cat") for e in json.load(f)["traceEvents"]
                 if e.get("name", "").startswith("mm.")}
    assert kinds == {"mm.outer": "cpu_op", "mm.inner": "cpu_op"}
    # With no profiler recording, a span adds to the totals alone.
    with profiling.span("unrecorded"):
        pass
    assert profiling.totals()["unrecorded"]["count"] == 1


def test_scan_step_records_its_spans(fresh):
    """A call of make_scan_step on a CPU state: step.call around the input
    upload and the display, on the timeline and in the totals."""
    scene = upload_scene(build_scene(TINY.maze), device="cpu")
    step = make_scan_step(scene, TINY)
    state = init_state(TINY, device="cpu")
    frames = [FrameInputs.idle()] * 3
    with profiling.trace() as prof:
        state, shown = step(state, frames)
    assert shown.shape == (16, 24, 3)
    ev = _mm_events(prof)
    assert {k: len(v) for k, v in ev.items()} == {
        "mm.step.call": 1, "mm.step.upload": 1, "mm.step.display": 1}
    call = ev["mm.step.call"][0]
    upload, shown_at = ev["mm.step.upload"][0], ev["mm.step.display"][0]
    assert _inside(upload, call) and _inside(shown_at, call) and upload[1] <= shown_at[0]
    t = profiling.totals()
    assert {k: t[k]["count"] for k in t} == {"step.call": 1, "step.upload": 1,
                                             "step.display": 1}
    assert t["step.call"]["self_seconds"] < t["step.call"]["seconds"]


def test_kernel_build_and_load_are_spans(fresh, monkeypatch, tmp_path):
    """``kernels.build`` compiles a missing library inside the span
    ``kernels.build`` and binds it inside ``kernels.load``; a library built
    before is only loaded."""
    built = []
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_lib_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(kernels, "_compile", lambda names, verbose: (
        built.extend(names), [(tmp_path / f"lib{n}.so").touch() for n in names]))
    monkeypatch.setattr(kernels, "_bind", lambda name, symbol, argtypes: (name, symbol))
    assert kernels.build(("present", "resolve")) == {"present": ("present", "mm_present"),
                                                     "resolve": ("resolve", "mm_resolve")}
    t = profiling.totals()
    assert built == ["present", "resolve"]
    assert t["kernels.build"]["count"] == 1 and t["kernels.load"]["count"] == 1
    monkeypatch.setattr(kernels, "_libs", {})
    kernels.build(("present",))
    kernels.build(("present",))           # bound already: nothing to do
    t = profiling.totals()
    assert built == ["present", "resolve"]
    assert t["kernels.build"]["count"] == 1 and t["kernels.load"]["count"] == 2


def test_tracer_counters_are_the_kernels_in_its_order():
    """fused_tracer.COUNTERS names csrc/tracer.cu's Count words in order, and
    COUNT_BYTES is the shared memory of its warps' counts."""
    import re

    from mirror_maze_tpu_torch.render import fused_tracer

    src = (kernels.CSRC / "tracer.cu").read_text()
    enum = re.search(r"enum Count \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*([A-Z_]+),", enum, re.M)     # COUNTS, last, has no comma
    assert [n.lower() for n in names] == list(fused_tracer.COUNTERS)
    shape = re.search(r"__shared__ unsigned long long warp_counts\[(\w+)\]\[(\w+)\];", src)
    warps = int(re.search(r"#define WARPS (\d+)", src).group(1))
    assert shape.groups() == ("WARPS", "COUNTS")
    assert fused_tracer.COUNT_BYTES == warps * len(names) * 8
