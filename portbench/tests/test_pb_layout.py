"""BENCHMARK.json against the benchmark's contract, and each configuration
file against the port's preset it stands for, with its stated overrides."""

import copy
import dataclasses
import json
import re

import pytest

from portbench import run
from portbench.reference import check

from . import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def plain(x):
    """Tuples as lists, for comparing a dataclass with its JSON."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


CONFIGS = [c["name"] for c in tiny.bench()["configs"]]


def config_file(name: str) -> dict:
    return run.load_json(run.PKG / "configs" / f"{name}.json")


def replaced(obj, path: list, value):
    """``obj`` with the field at ``path`` (names of nested dataclasses) set."""
    if len(path) > 1:
        value = replaced(getattr(obj, path[0]), path[1:], value)
    return dataclasses.replace(obj, **{path[0]: value})


def field_at(obj, path: list):
    for name in path:
        obj = getattr(obj, name)
    return obj


def as_field(value):
    return tuple(value) if isinstance(value, list) else value


def holds_to_its_preset(got: dict) -> None:
    """A configuration file's ``engine`` is its ``preset`` (a function of the
    port's config module) with its ``overrides`` (field path -> value) set,
    field for field: every field that differs is stated, and each stated
    value is what ``run.engine_config`` reads."""
    from mirror_maze_tpu_torch import config

    want = getattr(config, got["preset"])()
    for path, value in got["overrides"].items():
        want = replaced(want, path.split("."), as_field(value))
    assert got["engine"] == plain(dataclasses.asdict(want))
    engine = run.engine_config(got["engine"])
    assert engine == want
    for path, value in got["overrides"].items():
        assert field_at(engine, path.split(".")) == as_field(value), path


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_is_the_ports_preset_field_for_field(name):
    got = config_file(name)
    assert isinstance(got["overrides"], dict)
    holds_to_its_preset(got)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_names_a_reference_route_that_exists(name):
    got = config_file(name)
    assert (run.PKG / "reference" / f"{got['reference']}.py").exists()
    route = check.route_of(got)
    assert callable(route.build) and callable(route.trace)


def test_a_configuration_on_another_intersector_needs_only_its_overrides():
    """``config_interactive`` with ``intersector`` bvh, as a file of its own
    would state it, passes the same check; an unstated change fails it."""
    got = config_file("interactive")
    got.update(name="interactive-bvh", overrides={"intersector": "bvh"})
    got["engine"]["intersector"] = "bvh"
    holds_to_its_preset(got)
    nested = copy.deepcopy(got)
    nested["overrides"]["camera.spawn"] = [-5.0, 0.0, -35.0]
    nested["engine"]["camera"]["spawn"] = [-5.0, 0.0, -35.0]
    holds_to_its_preset(nested)
    unstated = copy.deepcopy(got)
    unstated["engine"]["screen"]["samples_per_pixel"] = 32
    with pytest.raises(AssertionError):
        holds_to_its_preset(unstated)


def test_benchmark_json_keeps_the_contracts_shape():
    b = tiny.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len(json.dumps(b)) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["portbench"] and b["command"][:3] == ["python3", "-m", "portbench.run"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert run.load_json(run.ROOT / c["file"])["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["source"]) <= 200
    cells = {w["name"] for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        loop = run.loops.find(run.traffic.load(w["traffic"], run.PKG)["loop"])
        assert all(callable(getattr(loop, f)) for f in ("make_call", "warm_up", "drive"))
        assert (run.PKG / "limits" / f"{w['name']}.json").exists()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(run.reader(m["name"]).read)
    # setup_s names no cells: every cell, those added later too, reports it.
    assert "workloads" not in next(e for e in b["end_to_end"] if e["name"] == "setup_s")
    for cell in cells:
        reported = {m["name"] for m in run.metrics_of(b, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert run.metrics_of(b, cell, "per_layer")
        for m in run.metrics_of(b, cell, "per_layer"):
            moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", cells)
