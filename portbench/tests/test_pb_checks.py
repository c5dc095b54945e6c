"""``correct`` at the test size on the CPU: true for the port, false for the
control (the reference in bfloat16 in the program's place) and for the
timed path broken underneath in each way a cell can break."""

import pytest
import torch

from portbench import run

from . import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_port_is_correct_and_the_control_is_not(cell):
    rec = tiny.run_tiny(cell, seed=2 ** 33 + 11)
    plan = tiny.plan(cell)
    program = run.check_numbers(rec, plan)
    assert tiny.correct(rec, cell, program), program
    assert program == dict(state_mismatch=0, pose_gap=0.0, pixel_off_share=0.0,
                           pixel_max_gap=0)
    control = run.check_numbers(rec, plan, control=torch.bfloat16)
    assert not tiny.correct(rec, cell, control), control


def unchanged(scene, cfg, n_chunks, state, inp, rotate, nearest_fn=None):
    return state


def half_the_samples(light, spp, screen=None, ids=None, in_place=False):
    """The resolve with half of each pixel's samples left out and the mean
    taken over the rest."""
    kept = light.reshape(-1, spp, 3)[:, :spp // 2].reshape(-1, 3)
    return ORIGINAL["resolve_plain"](kept, spp // 2, screen, ids, in_place)


def altered(light, spp, screen=None, ids=None, in_place=False):
    """The resolve with the first refreshed pixel's answer altered."""
    light = light.clone()
    light[:spp] += 0.5
    return ORIGINAL["resolve_plain"](light, spp, screen, ids, in_place)


ORIGINAL = {}
FAULTS = {
    "a step that returns its state unchanged": ("runtime.step", "_advance", unchanged),
    "half of the samples left out, the mean over the rest": (
        "render.frame_glue", "resolve_plain", half_the_samples),
    "an answer altered where it is produced": ("render.frame_glue", "resolve_plain", altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    module, name, fn = FAULTS[fault]
    mod = importlib.import_module(f"mirror_maze_tpu_torch.{module}")
    ORIGINAL[name] = getattr(mod, name)
    monkeypatch.setattr(mod, name, fn)
    rec = tiny.run_tiny(cell, seed=2 ** 31 + 12)
    monkeypatch.undo()
    numbers = run.check_numbers(rec, tiny.plan(cell))
    assert not tiny.correct(rec, cell, numbers), numbers
