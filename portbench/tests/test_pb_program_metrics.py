"""The metrics read from the program's own spans and counters: None from a
program that keeps none (as before it had them), their value on a synthetic
record; and the program's ``mm.`` spans on the timeline leave every value
``trace.reduce`` gives as it was."""

import importlib

import pytest
import torch

from portbench import trace

from . import tiny

SPANS = {"kernels.build": (1, 30.0, 30.0), "kernels.load": (11, 0.5, 0.5),
         "graph.eager": (1, 4.0, 3.2), "graph.capture": (1, 1.5, 1.3),
         "step.call": (40, 2.0, 0.1)}


def read(name, rec):
    return importlib.import_module(f"portbench.metrics.{name}").read(rec)


def totals(spans=SPANS):
    return lambda: {k: dict(count=c, seconds=s, self_seconds=own)
                    for k, (c, s, own) in spans.items()}


def traced(frames=600, gaps=(("fetch", 0.3), ("step", 0.09), ("harness", 0.1))):
    return dict(device=torch.device("cuda"),
                trace=dict(frames=frames, breakdown=dict(idle_gaps=[list(g) for g in gaps])))


@pytest.fixture
def profiling():
    from mirror_maze_tpu_torch.utils import profiling
    return profiling


@pytest.fixture
def fused_tracer():
    from mirror_maze_tpu_torch.render import fused_tracer
    return fused_tracer


@pytest.mark.parametrize("name", ["kernel_load_s", "warmup_s"])
def test_span_readers_read_nothing_from_a_program_without_spans(name, profiling, monkeypatch):
    monkeypatch.delattr(profiling, "totals")
    assert read(name, traced()) is None


def test_step_idle_reads_the_step_gaps_whatever_the_program_keeps(profiling, monkeypatch):
    """The step's idle gaps are the benchmark's own ``pb.step`` span's, so a
    program without spans reads them too."""
    monkeypatch.delattr(profiling, "totals")
    assert read("step_idle_ms", traced(frames=600)) == pytest.approx(0.09 * 1e3 / 600)
    assert read("step_idle_ms", dict(trace=None)) is None


def test_lane_share_reads_nothing_from_a_program_without_counters(fused_tracer, monkeypatch):
    monkeypatch.delattr(fused_tracer, "counters")
    assert read("tracer_lane_share", traced()) is None


def test_span_readers_on_a_synthetic_registry(profiling, monkeypatch):
    monkeypatch.setattr(profiling, "totals", totals())
    # The load alone: a build is made only in a checkout's first run.
    assert read("kernel_load_s", {}) == pytest.approx(0.5)
    # Self time: the loads inside the eager frame stay out of the warm-up.
    assert read("warmup_s", {}) == pytest.approx(3.2 + 1.3)
    assert read("step_idle_ms", traced(frames=600)) == pytest.approx(0.09 * 1e3 / 600)
    assert read("step_idle_ms", traced(gaps=[("fetch", 0.3)])) == 0.0
    assert read("step_idle_ms", dict(trace=None)) is None
    monkeypatch.setattr(profiling, "totals", totals({"graph.eager": (1, 0.2, 0.2)}))
    assert read("kernel_load_s", {}) == 0.0            # no library was loaded
    monkeypatch.setattr(profiling, "totals", totals({"kernels.load": (3, 0.2, 0.2)}))
    assert read("warmup_s", {}) == 0.0


def test_lane_share_on_synthetic_counters(fused_tracer, monkeypatch):
    counts = dict(ray_segments=10, warp_segments=1, tests_issued=3200, tests_needed=2720)
    monkeypatch.setattr(fused_tracer, "counters", lambda device: counts)
    assert read("tracer_lane_share", traced()) == pytest.approx(85.0)
    assert read("tracer_lane_share", dict(traced(), device=torch.device("cpu"))) is None
    monkeypatch.setattr(fused_tracer, "counters", lambda device: dict(counts, tests_issued=0))
    assert read("tracer_lane_share", traced()) is None


MS = 1_000_000


def records():
    """A window of two traced calls: device kernels and copies, the
    benchmark's spans, and the program's spans inside each step."""
    out = [("pb.window", "user_annotation", 0, 100 * MS)]
    for c in range(2):
        t = c * 50 * MS
        out += [("pb.step", "user_annotation", t + 2 * MS, t + 30 * MS),
                ("mm.step.call", "cpu_op", t + 3 * MS, t + 29 * MS),
                ("mm.step.upload", "cpu_op", t + 3 * MS, t + 6 * MS),
                ("mm.step.replays", "cpu_op", t + 6 * MS, t + 27 * MS),
                ("mm.step.display", "cpu_op", t + 27 * MS, t + 29 * MS),
                ("Memcpy HtoD", "gpu_memcpy", t + 7 * MS, t + 8 * MS),
                ("void trace_kernel<true>", "kernel", t + 10 * MS, t + 40 * MS),
                ("present", "kernel", t + 40 * MS, t + 42 * MS),
                ("pb.fetch", "user_annotation", t + 30 * MS, t + 45 * MS),
                ("Memcpy DtoH", "gpu_memcpy", t + 43 * MS, t + 45 * MS)]
    return out


def test_program_spans_on_the_timeline_leave_the_reduction_as_it_was():
    plain = [r for r in records() if not r[0].startswith("mm.")]
    got, want = trace.reduce(records(), 120), trace.reduce(plain, 120)
    assert got.pop("records") == dict(want.pop("records"), cpu_op=8)
    assert got == want
    # Idle 0-7, 8-10 and 58-60 ms in the steps, 42-43 and 92-93 in the
    # fetches, 45-57 (its midpoint before the second step) and 95-100 outside.
    gaps = dict(got["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx(dict(step=11e-3, fetch=2e-3, harness=17e-3))


def test_a_traced_run_on_the_cpu_reads_the_programs_spans():
    rec = tiny.run_tiny("interactive.refine", seconds=1.0, trace=True)
    assert read("kernel_load_s", rec) == 0.0          # the CPU loads no library
    assert read("warmup_s", rec) == 0.0               # nor captures a graph
    assert read("step_idle_ms", rec) >= 0.0
    assert read("tracer_lane_share", rec) is None


LONG = "void resolve_kernel<" + "x" * 200 + ">"


def test_by_kernel_gives_each_kernel_of_the_window_its_seconds_and_launches():
    """Kernels by name (cut to 120 characters), those that overlap the
    window alone; copies and spans are no kernels."""
    recs = records() + [(LONG, "kernel", 46 * MS, 47 * MS), (LONG, "kernel", 93 * MS, 94 * MS),
                        ("void trace_kernel<true>", "kernel", 101 * MS, 130 * MS),
                        ("present", "kernel", -9 * MS, -1 * MS)]
    got = trace.reduce(recs, 120)["by_kernel"]
    assert set(got) == {"void trace_kernel<true>", "present", LONG[:120]}
    assert got["void trace_kernel<true>"] == dict(seconds=pytest.approx(0.06), launches=2)
    assert got["present"] == dict(seconds=pytest.approx(0.004), launches=2)
    assert got[LONG[:120]] == dict(seconds=pytest.approx(0.002), launches=2)


def test_by_kernel_leaves_the_tracer_glue_and_breakdown_as_they_were():
    recs = records() + [(LONG, "kernel", 46 * MS, 47 * MS)]
    got = trace.reduce(recs, 120)
    assert got["tracer_s"] == pytest.approx(0.06) and got["tracer_launches"] == 2
    # The glue: every device operation but the tracer and the host copies.
    assert got["glue_s"] == pytest.approx(0.004 + 0.001) and got["kernels"] == 5
    ops = dict(got["breakdown"]["device_ops"])
    assert ops == pytest.approx({"void trace_kernel<true>": 0.06, "present": 0.004,
                                 "Memcpy DtoH": 0.004, "Memcpy HtoD": 0.002, LONG[:120]: 0.001})
    for name, k in got["by_kernel"].items():
        assert k["seconds"] == ops[name]
