"""The end-to-end metrics over the whole window and every frame."""

import importlib

import pytest

from . import tiny


def read(name, rec):
    return importlib.import_module(f"portbench.metrics.{name}").read(rec)


def record(frames, window_s, host_s=0.2, host_frames=None):
    return dict(setup_s=3.0, scene_setup_s=0.5, window_s=window_s, frames=frames,
                host_s=host_s, host_frames=frames if host_frames is None else host_frames)


def test_frame_ms_is_the_window_over_all_its_frames():
    assert read("frame_ms", record(1000, window_s=2.49)) == pytest.approx(2.49)
    assert read("frame_ms", record(300, window_s=0.9)) == pytest.approx(3.0)


def test_host_ms_is_over_the_untraced_calls_alone():
    assert read("host_ms", record(600, 1.0, host_s=0.03, host_frames=300)) == pytest.approx(0.1)
    assert read("host_ms", record(600, 1.0, host_frames=0)) is None


def test_a_run_on_the_cpu_reports_every_end_to_end_metric_of_its_cell():
    rec = tiny.run_tiny("interactive.refine", seconds=0.3)
    assert rec["frames"] >= 4 and rec["frames"] % 4 == 0 and rec["trace"] is None
    assert rec["host_frames"] == rec["frames"]
    assert read("frame_ms", rec) == pytest.approx(rec["window_s"] * 1e3 / rec["frames"])
    assert read("setup_s", rec) > read("scene_setup_s", rec) > 0


def test_a_traced_run_traces_the_second_half_of_its_window():
    rec = tiny.run_tiny("interactive.refine", seconds=1.0, trace=True)
    t = rec["trace"]
    assert 0 < t["frames"] <= rec["frames"] - rec["host_frames"]
    assert rec["host_frames"] > 0 and 0 < t["window_s"] < rec["window_s"]
    assert read("host_ms", rec) == pytest.approx(rec["host_s"] * 1e3 / rec["host_frames"])
