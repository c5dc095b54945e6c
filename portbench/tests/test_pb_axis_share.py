"""``tracer_axis_share``: None from a program whose counters hold no
``axis_tests`` (as before the tracer counted them) or that keeps no
counters, its value on synthetic counters."""

import importlib

import pytest
import torch


def read(rec):
    return importlib.import_module("portbench.metrics.tracer_axis_share").read(rec)


CUDA = dict(device=torch.device("cuda"))
COUNTS = dict(ray_segments=10, warp_segments=1, tests_issued=3200, tests_needed=2720,
              axis_tests=3072)


@pytest.fixture
def fused_tracer():
    from mirror_maze_tpu_torch.render import fused_tracer
    return fused_tracer


def test_axis_share_on_synthetic_counters(fused_tracer, monkeypatch):
    monkeypatch.setattr(fused_tracer, "counters", lambda device: COUNTS)
    assert read(CUDA) == pytest.approx(96.0)
    assert read(dict(device=torch.device("cpu"))) is None
    monkeypatch.setattr(fused_tracer, "counters", lambda device: dict(COUNTS, tests_issued=0))
    assert read(CUDA) is None


def test_axis_share_reads_nothing_from_a_program_without_the_counter(fused_tracer,
                                                                      monkeypatch):
    old = {k: v for k, v in COUNTS.items() if k != "axis_tests"}
    monkeypatch.setattr(fused_tracer, "counters", lambda device: old)
    assert read(CUDA) is None
    monkeypatch.delattr(fused_tracer, "counters")
    assert read(CUDA) is None


def test_axis_share_names_a_counter_of_the_kernel(fused_tracer):
    assert "axis_tests" in fused_tracer.COUNTERS
