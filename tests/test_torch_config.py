"""The port's config is the JAX package's config, field for field."""

import dataclasses

import pytest

import mirror_maze_tpu.config as J
import mirror_maze_tpu_torch.config as P


@pytest.mark.parametrize(
    "name", ["MazeConfig", "TracerConfig", "CameraConfig", "ScreenConfig", "EngineConfig"]
)
def test_field_defaults_equal(name):
    jf = {f.name: f for f in dataclasses.fields(getattr(J, name))}
    pf = {f.name: f for f in dataclasses.fields(getattr(P, name))}
    assert jf.keys() == pf.keys()
    jd = dataclasses.asdict(getattr(J, name)())
    pd = dataclasses.asdict(getattr(P, name)())
    assert jd == pd


@pytest.mark.parametrize("preset", sorted(J.NAMED_CONFIGS))
def test_named_configs_equal(preset):
    assert sorted(P.NAMED_CONFIGS) == sorted(J.NAMED_CONFIGS)
    j = J.NAMED_CONFIGS[preset]()
    p = P.NAMED_CONFIGS[preset]()
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert j.tracer.max_segments == p.tracer.max_segments
    assert j.screen.effective_chunks_per_frame == p.screen.effective_chunks_per_frame


def test_validation_matches():
    with pytest.raises(ValueError):
        P.ScreenConfig(width=30, height=32)
    with pytest.raises(ValueError):
        P.MazeConfig(rng="other")
    with pytest.raises(ValueError):
        P.EngineConfig(intersector="other")
