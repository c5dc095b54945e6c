"""The ``interactive-bvh.refine`` cell: its route ``segments`` decides
``correct`` (false for the control, the route in bfloat16, and for each
fault of ``test_pb_checks.py`` where the camera sees light), its three
rooflines count a traced run's work, its six metrics read the trace and the
walk kernel's counters, and none of its modules imports JAX or the port."""

import ast
import importlib
import json

import pytest
import torch

from portbench import run
from portbench.reference import check, segments
from portbench.roofline import bvh_walk, normal_draw, shade

from . import tiny
from .test_pb_checks import FAULTS, ORIGINAL

CELL = "interactive-bvh.refine"
METRICS = ("walk_roofline", "shade_roofline", "draw_roofline", "walk_live_share",
           "walk_nodes_per_ray", "segment_glue_ms")


def inside() -> dict:
    """The cell's configuration at the test size with the camera inside the
    4 x 4 maze (the test size's cut leaves it outside the world's walls, where
    the segment path sees no light), 5 + 3 segments."""
    cfg = tiny.config("interactive-bvh")
    cfg["engine"]["camera"]["spawn"] = [-5.0, 0.0, -15.0]
    cfg["engine"]["tracer"].update(bounce_limit=5, mirror_limit=3)
    return cfg


def run_inside(seed: int, trace: bool = False, seconds: float = 0.3) -> dict:
    bench = tiny.bench()
    return run.run_cell(bench, run.cell_of(bench, CELL), seed, seconds, trace, "cpu",
                        cfg_file=inside(), mix=tiny.mix("refine"))


@pytest.mark.parametrize("where", ["test size", "inside"])
def test_the_control_in_bfloat16_is_not_correct(where):
    rec = tiny.run_tiny(CELL, seed=2 ** 33 + 3) if where == "test size" else \
        run_inside(2 ** 33 + 3)
    plan = tiny.plan(CELL)
    program = run.check_numbers(rec, plan)
    assert program == dict(state_mismatch=0, pose_gap=0.0, pixel_off_share=0.0,
                           pixel_max_gap=0)
    control = run.check_numbers(rec, plan, control=torch.bfloat16)
    assert not tiny.correct(rec, CELL, control), control
    if where == "inside":
        # Inside the maze the control's pixels fail too, not its pose alone.
        limits = plan["limits"]
        assert control["pixel_off_share"] > limits["pixel_off_share"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct_where_the_camera_sees_light(fault, monkeypatch):
    """test_pb_checks.py's faults planted in the cell with the camera inside
    the maze: each fails ``correct``, "half of the samples" too, which the
    test size's black frames cannot show."""
    module, name, fn = FAULTS[fault]
    mod = importlib.import_module(f"mirror_maze_tpu_torch.{module}")
    ORIGINAL[name] = getattr(mod, name)
    monkeypatch.setattr(mod, name, fn)
    rec = run_inside(2 ** 31 + 12)
    monkeypatch.undo()
    numbers = run.check_numbers(rec, tiny.plan(CELL))
    assert not tiny.correct(rec, CELL, numbers), numbers


@pytest.fixture(scope="module")
def traced():
    rec = run_inside(2 ** 31 + 21, trace=True, seconds=0.6)
    reference = check.Reference(rec["cfg_file"], rec["seed"], rec["stepped"], "cpu")
    return rec, reference


def test_the_rooflines_count_the_routes_work_of_a_traced_run(traced):
    rec, reference = traced
    tc = rec["cfg_file"]["engine"]["tracer"]
    segs = tc["bounce_limit"] + tc["mirror_limit"]
    walk, sh, draw = (m.work(rec, reference) for m in (bvh_walk, shade, normal_draw))
    st = walk["stats"]
    assert st is sh["stats"] and walk["frames"] == sh["frames"] == draw["frames"]
    assert walk["segments"] == sh["segments"] == segs == len(st["alive"])
    rays = draw["rays"]
    # A frame at the test size: 4 chunks of 16 pixels at 4 samples.
    assert rays == 4 * 16 * 4
    # The sample's sums over its frames, scaled to one frame.
    scale = rays / walk["sampled_rays"]
    assert st["alive"][0] == walk["sampled_rays"] and st["rays"] == walk["sampled_rays"]
    # The first segment walks every ray of a frame.
    assert st["alive"][0] * scale == rays
    ops = sum(bvh_walk.SLAB_OPS * a + bvh_walk.PRIM_OPS * b
              for a, b in zip(st["slab_tests"], st["prim_tests"])) * scale / segs
    assert walk["ops"] == pytest.approx(ops) and walk["ops"] > 0
    assert sh["bytes"] > rays and draw["ops"] == 79 * 3 * rays and draw["bytes"] == 12 * rays
    for w in (walk, sh, draw):
        assert w["bound_ms"] > 0 and w["bound_by"] in ("operations", "bytes")
    assert sh["bound_by"] == "bytes"


def test_a_traced_run_on_the_cpu_counts_the_three_rooflines_and_prints_no_kernel(
        traced, monkeypatch, capsys):
    rec, _ = traced
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    bench = tiny.bench()
    assert run.report(bench, run.cell_of(bench, CELL), rec) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(rec["rooflines"]) == {"bvh_walk", "shade", "normal_draw"}
    # The CPU launches no kernel and keeps no walk counter.
    assert not set(METRICS) & set(line["metrics"])


def read(name, rec):
    return importlib.import_module(f"portbench.metrics.{name}").read(rec)


WALK = "void (anonymous namespace)::bvh_walk<false>(float const*, float const*, int)"
SHADE = "void (anonymous namespace)::shade_kernel<false, false, false, false>(Params)"
DRAW = "void (anonymous namespace)::threefry_kernel<0, 3>((anonymous namespace)::Args)"
FOLD = "void (anonymous namespace)::threefry_kernel<1, 0>((anonymous namespace)::Args)"


def card(by_kernel: dict, **bounds) -> dict:
    return dict(trace=dict(by_kernel=by_kernel),
                rooflines={k: dict(bound_ms=v) for k, v in bounds.items()})


def test_the_roofline_readers_read_their_kernels_by_name():
    kernels = {WALK: dict(seconds=0.013, launches=130), SHADE: dict(seconds=0.0065, launches=130),
               DRAW: dict(seconds=0.0052, launches=130), FOLD: dict(seconds=0.5, launches=130)}
    rec = card(kernels, bvh_walk=0.01, shade=0.03, normal_draw=0.012)
    assert read("walk_roofline", rec) == pytest.approx(10.0)
    assert read("shade_roofline", rec) == pytest.approx(60.0)
    # The normal draw alone: the fold_in instance is not the draw.
    assert read("draw_roofline", rec) == pytest.approx(30.0)
    mangled = {"_ZN12_GLOBAL__N_115threefry_kernelILi0ELi3EEEvNS_4ArgsE":
               dict(seconds=0.0052, launches=130)}
    assert read("draw_roofline", card(mangled, normal_draw=0.012)) == pytest.approx(30.0)


@pytest.mark.parametrize("name", ["walk_roofline", "shade_roofline", "draw_roofline"])
def test_a_roofline_reader_reads_nothing_where_its_kernel_did_not_run(name):
    others = {"void trace_kernel<true>": dict(seconds=1.0, launches=10), FOLD: dict(
        seconds=0.1, launches=10)}
    assert read(name, card(others, bvh_walk=0.1, shade=0.1, normal_draw=0.1)) is None
    assert read(name, card({WALK: dict(seconds=1.0, launches=10)})) is None
    assert read(name, dict(trace=None)) is None


def test_the_segment_glue_is_every_device_operation_but_the_three_kernels():
    kernels = {WALK: dict(seconds=0.013, launches=130), SHADE: dict(seconds=0.0065, launches=130),
               DRAW: dict(seconds=0.0052, launches=130), FOLD: dict(seconds=0.0002, launches=130)}
    rec = card(kernels)
    # 10 frames; the glue's own 0.0012 s are the fold_in and the copies.
    rec["trace"].update(kernels=520, frames=10, glue_s=0.013 + 0.0065 + 0.0052 + 0.0012)
    assert read("segment_glue_ms", rec) == pytest.approx(0.12)
    fused = card({"void trace_kernel<true>": dict(seconds=1.0, launches=10)})
    fused["trace"].update(kernels=10, frames=10, glue_s=0.001)
    assert read("segment_glue_ms", fused) is None
    assert read("segment_glue_ms", dict(trace=None)) is None
    assert read("segment_glue_ms", dict(trace=dict(kernels=0))) is None


@pytest.fixture
def intersect():
    from mirror_maze_tpu_torch.render import intersect
    return intersect


def counted() -> dict:
    return dict(device=torch.device("cuda"))


def test_the_counter_readers_on_synthetic_counters(intersect, monkeypatch):
    # Half of the threads the walks started walked a ray, 13 nodes each.
    c = dict(walk_rays=7680, walk_nodes=99840, walk_threads=15360)
    monkeypatch.setattr(intersect, "counters", lambda device: c)
    rec = counted()
    assert read("walk_live_share", rec) == pytest.approx(50.0)
    assert read("walk_nodes_per_ray", rec) == pytest.approx(13.0)
    assert read("walk_live_share", dict(rec, device=torch.device("cpu"))) is None
    monkeypatch.setattr(intersect, "counters", lambda device: dict.fromkeys(c, 0))
    assert read("walk_live_share", rec) is None and read("walk_nodes_per_ray", rec) is None


@pytest.mark.parametrize("name", ["walk_live_share", "walk_nodes_per_ray"])
def test_the_counter_readers_read_nothing_from_a_program_without_counters(name, intersect,
                                                                          monkeypatch):
    monkeypatch.delattr(intersect, "counters")
    assert read(name, counted()) is None


NEW = ["reference.segments", "roofline.segment_sample", "roofline.bvh_walk", "roofline.shade",
       "roofline.normal_draw"]


@pytest.mark.parametrize("module", NEW)
def test_the_route_and_its_rooflines_import_no_jax_and_nothing_of_the_port(module):
    path = run.PKG / f"{module.replace('.', '/')}.py"
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                 else [])
        for name in names:
            assert name.split(".")[0] in {"numpy", "torch", "__future__", "typing"}, name


def test_the_route_holds_every_floating_value_in_the_controls_dtype():
    cfg = inside()["engine"]
    scene = segments.build(cfg, "cpu")
    low = segments.in_dtype(scene, torch.bfloat16)
    assert low.normal.dtype == low.node_min.dtype == torch.bfloat16
    assert low.count.dtype == torch.int64 and scene.levels >= 3
