"""What a cell is checked and counted against follows its configuration: the
reference route its file names, the frame's tracer key, the rooflines its
metrics name. A route, a kernel-time metric and a roofline are added here
as new modules only (registered for the test), with no edit to a file of
the harness."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import check, prng, sim
from portbench.reference import frame as fr
from portbench.reference import scene as sc
from portbench.reference import tracer as tracer_route
from portbench.roofline import tracer as roof

from . import tiny

ZEROS = dict(state_mismatch=0, pose_gap=0.0, pixel_off_share=0.0, pixel_max_gap=0)


def add_module(monkeypatch, name: str, **attrs) -> types.ModuleType:
    """A module ``name`` that exists only for the test, with ``attrs``."""
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    monkeypatch.setitem(sys.modules, name, mod)
    return mod


def add_route(monkeypatch, name: str, trace) -> types.ModuleType:
    return add_module(monkeypatch, f"portbench.reference.{name}", build=tracer_route.build,
                      trace=trace)


@pytest.mark.parametrize("route,message", [("no_such_route", "'no_such_route'"),
                                           ("check", "'check'"), ("a.b", "'a.b'"),
                                           (None, "names no reference route")])
def test_a_route_the_reference_lacks_fails_with_its_name(route, message):
    cfg = tiny.config("interactive")
    if route is None:
        del cfg["reference"]
    else:
        cfg["reference"] = route
    with pytest.raises(ValueError, match=message):
        check.route_of(cfg)
    with pytest.raises(ValueError, match=message):
        check.Reference(cfg, 1, [], "cpu")


def test_a_run_on_an_unknown_route_fails_before_a_frame_is_stepped(monkeypatch):
    cfg = tiny.config("interactive")
    cfg["reference"] = "no_such_route"
    monkeypatch.setattr(run.loops, "find", lambda name: pytest.fail("the run went on"))
    bench = tiny.bench()
    with pytest.raises(ValueError, match="no_such_route"):
        run.run_cell(bench, run.cell_of(bench, "interactive.refine"), 7, 0.2, False, "cpu",
                     cfg_file=cfg, mix=tiny.mix("refine"))


@pytest.mark.parametrize("cell", ["interactive.refine", tiny.TURNING])
def test_a_route_added_as_a_module_decides_correct_as_the_tracer_does(cell, monkeypatch):
    calls = []

    def trace(scene, ori, dirs, ray_ids, frames, anchor, tc, dtype, budget, stats=None):
        assert all(isinstance(f, sim.Frame) for f, _ in frames)
        assert sum(n for _, n in frames) == ray_ids.numel() == ori.shape[0]
        calls.append(len(frames))
        return tracer_route.trace(scene, ori, dirs, ray_ids, frames, anchor, tc, dtype, budget,
                                  stats=stats)
    add_route(monkeypatch, "copied", trace)
    rec = tiny.run_tiny(cell, seed=2 ** 32 + 5)
    plan = tiny.plan(cell)
    want = run.check_numbers(rec, plan)
    rec["cfg_file"]["reference"] = "copied"
    got = run.check_numbers(rec, plan)
    assert calls and got == want == ZEROS
    # A call of many frames with the camera at rest is traced in one.
    assert max(calls) > 1


@pytest.mark.parametrize("cell", ["interactive.refine", "scale.refine"])
def test_a_route_whose_light_is_off_makes_correct_false(cell, monkeypatch):
    def brighter(*args, **kwargs):
        return tracer_route.trace(*args, **kwargs) * 1.5 + 0.05
    add_route(monkeypatch, "brighter", brighter)
    rec = tiny.run_tiny(cell, seed=2 ** 31 + 3)
    rec["cfg_file"]["reference"] = "brighter"
    numbers = run.check_numbers(rec, tiny.plan(cell))
    assert not tiny.correct(rec, cell, numbers), numbers


SCRIPT = ([((False,) * 4, 0.0, False)] * 3 + [((False, False, False, True), 0.0, False)] * 2
          + [((True, False, False, False), -12.0, True)] * 3)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12, 2 ** 33 + 11])
def test_a_frames_tracer_key_gives_its_seed(seed):
    cfg = tiny.config("interactive")["engine"]
    engine = sim.Engine(cfg, seed, tracer_route.build(cfg, "cpu"))
    frames = sim.run(engine, SCRIPT, set(range(1, len(SCRIPT) + 1)))
    assert len({f.tkey for f in frames.values()}) == len(SCRIPT)
    for n, f in frames.items():
        assert prng.tracer_seed(f.tkey) == f.seed
        assert (f.jkey, f.tkey) == tuple(prng.split(prng.fold_in(f.key, n)))


def test_a_frames_tracer_key_is_the_ports(monkeypatch):
    """The key each frame of the port's step draws its trace from, frame by
    frame, as the reference works it out from the seed and the script."""
    from mirror_maze_tpu_torch.runtime import step

    keys = []
    plain = step.frame_setup_plain

    def recording(*args, **kwargs):
        out = plain(*args, **kwargs)
        keys.append(tuple(int(k) & prng.MASK for k in out.tkey.tolist()))
        return out
    monkeypatch.setattr(step, "frame_setup_plain", recording)
    seed = 2 ** 33 + 19
    rec = tiny.run_tiny(tiny.TURNING, seed=seed, seconds=0.2)
    engine = sim.Engine(rec["cfg_file"]["engine"], seed,
                        tracer_route.build(rec["cfg_file"]["engine"], "cpu"))
    frames = sim.run(engine, rec["stepped"], set(range(1, len(rec["stepped"]) + 1)))
    assert len(keys) >= len(rec["stepped"]) > 8
    # The last frames recorded are the run's; a graph kind's first frame may
    # also step a scratch state first.
    assert keys[-len(rec["stepped"]):] == [frames[n].tkey for n in sorted(frames)]


def traced():
    return tiny.run_tiny("interactive.refine", seed=2 ** 31 + 21, seconds=0.6, trace=True)


def bench_without(names: set) -> dict:
    b = tiny.bench()
    b["per_layer"] = [m for m in b["per_layer"] if m["name"] not in names]
    return b


def test_report_counts_no_roofline_that_no_metric_of_the_cell_names(monkeypatch, capsys):
    def raising(rec, reference):
        raise AssertionError("a roofline no metric reads was counted")
    monkeypatch.setattr(roof, "work", raising)
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    rec = traced()
    bench = bench_without({"tracer_roofline"})
    assert run.report(bench, run.cell_of(bench, "interactive.refine"), rec) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is True and "tracer_roofline" not in line["metrics"]
    assert rec["rooflines"] == {} and "tracer_work" not in out.err


def test_report_counts_the_roofline_a_metric_names_on_the_configurations_route(monkeypatch,
                                                                                capsys):
    seen = []
    work = roof.work

    def counting(rec, reference):
        seen.append(reference.route)
        return work(rec, reference)
    monkeypatch.setattr(roof, "work", counting)
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    rec = traced()
    bench = tiny.bench()
    assert run.report(bench, run.cell_of(bench, "interactive.refine"), rec) == 0
    assert seen == [tracer_route] and set(rec["rooflines"]) == {"tracer"}
    assert '"tracer_work"' in capsys.readouterr().err
    # An untraced run prints the end-to-end metrics, which name no roofline.
    seen.clear()
    rec = tiny.run_tiny("interactive.refine", seed=2 ** 31 + 21, seconds=0.3)
    assert run.report(bench, run.cell_of(bench, "interactive.refine"), rec) == 0
    assert seen == [] and rec["rooflines"] == {}


def parents_tracer_work(rec: dict, frames: int = 4, chunks: int = 64) -> dict:
    """The count as the harness made it before rooflines were named by their
    metrics: one function over the plain tracer, kept here as it was."""
    cfg = rec["cfg_file"]["engine"]
    traced_frames = rec["trace"]["frames"]
    script, first = rec["stepped"], len(rec["stepped"]) - traced_frames
    rng = np.random.default_rng([rec["seed"], 0x700F])
    numbers = sorted(int(n) for n in rng.choice(np.arange(first + 1, len(script) + 1),
                                                min(frames, traced_frames), replace=False))
    scene = sc.build(cfg, "cpu")
    engine = sim.Engine(cfg, rec["seed"], scene)
    stepped = sim.run(engine, script, set(numbers))
    s = cfg["screen"]
    cw, spp, ppc = s["chunk_width"], s["samples_per_pixel"], s["chunk_width"] ** 2
    rng = np.random.default_rng([rec["seed"], 0x0B5])
    stats, sampled, total = {}, 0, 0
    for n in numbers:
        f = stepped[n]
        ids = f.ids
        k = torch.from_numpy(rng.choice(ids.numel(), min(chunks, ids.numel()), replace=False))
        pix = fr.chunk_pixels(ids[k] % (s["width"] // cw), ids[k] // (s["width"] // cw), cw)
        index = (k[:, None] * ppc + torch.arange(ppc)).reshape(-1)
        ori, dirs, ray_ids = fr.rays(cfg, f.center, f.quat, pix, index, f.jkey, torch.float32)
        tracer_route.trace_paths(scene.planes, scene.tiles, scene.group_meta, ori, dirs, f.seed,
                                 cfg["tracer"], ray_ids, f.center.float(), stats=stats)
        sampled += ray_ids.numel()
        total += ids.numel() * ppc * spp
    walked = sum(n for _, _, n in scene.group_meta if n > 1)
    ops = roof.operations(stats, walked) * total / sampled / len(numbers)
    n_bytes = roof.bytes_moved(total // len(numbers))
    bound, by = roof.bound_ms(ops, n_bytes)
    return dict(ops=ops, bytes=n_bytes, bound_ms=bound, bound_by=by, frames=numbers,
                sampled_rays=sampled, stats=stats)


def test_the_tracers_roofline_counts_what_the_harness_counted_before():
    rec = traced()
    got = roof.work(rec, check.Reference(rec["cfg_file"], rec["seed"], rec["stepped"], "cpu"))
    want = parents_tracer_work(rec)
    assert got == want and got["ops"] > 0 and len(got["frames"]) >= 1


def test_a_route_a_kernel_metric_and_a_roofline_come_as_new_modules_alone(monkeypatch,
                                                                           capsys):
    """A configuration on a route of its own, a metric of a kernel's time
    over the roofline it names, and that roofline's count: three modules
    and entries of BENCHMARK.json, no file of the harness edited."""
    routes, counted = [], []

    def trace(*args, **kwargs):
        routes.append(1)
        return tracer_route.trace(*args, **kwargs)
    route = add_route(monkeypatch, "own_route", trace)

    def work(rec, reference):
        counted.append(reference.route)
        return dict(bound_ms=0.5)
    add_module(monkeypatch, "portbench.roofline.walk", work=work)

    def read(rec):
        t, r = rec.get("trace"), rec.get("rooflines", {}).get("walk")
        walks = [k for n, k in (t or {}).get("by_kernel", {}).items() if "bvh_walk" in n]
        if not r or not walks:
            return None
        ms = sum(k["seconds"] for k in walks) * 1e3 / sum(k["launches"] for k in walks)
        return r["bound_ms"] / ms * 100.0
    metric = add_module(monkeypatch, "portbench.metrics.walk_roofline", ROOFLINE="walk",
                        read=read)
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])

    bench = tiny.bench()
    cell = run.cell_of(bench, "interactive.refine")
    bench["per_layer"].append(dict(name="walk_roofline", unit="%", better="higher",
                                   source="device_trace", layer="bvh walk kernel",
                                   moves="frame_ms", workloads=[cell["name"]]))
    cfg = tiny.config("interactive")
    cfg["reference"] = "own_route"
    rec = run.run_cell(bench, cell, 2 ** 31 + 40, 0.6, True, "cpu", cfg_file=cfg,
                       mix=tiny.mix("refine"))
    assert run.report(bench, cell, rec) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and routes
    assert counted == [route] and rec["rooflines"]["walk"] == dict(bound_ms=0.5)
    # The CPU runs no kernel, so the metric finds nothing and is left out ...
    assert rec["trace"]["by_kernel"] == {} and "walk_roofline" not in line["metrics"]
    # ... and on a card's record it reads the walk's time a launch.
    card = dict(trace=dict(by_kernel={"void bvh_walk_kernel<64>": dict(seconds=0.02,
                                                                       launches=10),
                                      "shade_kernel": dict(seconds=1.0, launches=10)}),
                rooflines=dict(walk=dict(bound_ms=0.5)))
    assert metric.read(card) == pytest.approx(25.0)
