"""BENCHMARK.json against the benchmark's contract, and each configuration
file against the port's preset it stands for."""

import dataclasses
import json
import re

import pytest

from portbench import run

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


@pytest.mark.parametrize("name", ["interactive", "scale"])
def test_config_file_is_the_ports_preset_field_for_field(name):
    from mirror_maze_tpu_torch.config import NAMED_CONFIGS

    got = run.load_json(run.PKG / "configs" / f"{name}.json")
    want = plain(dataclasses.asdict(NAMED_CONFIGS[name]()))
    assert got["engine"] == want
    assert got["preset"] == f"config_{name}"
    assert run.engine_config(got["engine"]) == NAMED_CONFIGS[name]()


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
