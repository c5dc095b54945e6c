"""The one traffic generator: a mix's data file (``traffic/<mix>.json``)
and the seed give the frames a run steps, as (keys, mouse_dx, rotates),
keys the four booleans A, S, D, W.

A mix names the loop that steps its frames (``loop``: the module
``portbench/loops/<loop>.py``) and the frames a call takes
(``frames_per_call``), the warm-up before the window (``warmup``: runs of
[kind, frames]), and the window's frames: cycles of ``cycle_frames``, each
cut into runs of ``run_frames`` [least, most] frames that hold one input of
a kind, the kinds' shares of frames given by ``mix``. Every cycle holds the
same runs; the seed draws their order, the keys a walking run holds (1 or
2 of WASD, ``keys_held``) and a looking run's mouse delta (a whole number
of pixels in ``mouse_dx``, its sign held for the run). Kinds: ``idle``,
``walk``, ``look``, ``walk_look``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np

KINDS = ("idle", "walk", "look", "walk_look")


def load(name: str, root: Path) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def cycle_runs(mix: dict) -> list:
    """The runs of one cycle, [(kind, frames)], the same for every seed:
    each kind's frames cut into runs whose lengths step evenly through
    ``run_frames``, the last run taking what is left."""
    lo, hi = mix["run_frames"]
    lengths = [lo] if lo == hi else list(np.linspace(lo, hi, 4).round().astype(int))
    runs = []
    for kind in KINDS:
        left = int(round(mix["mix"].get(kind, 0.0) * mix["cycle_frames"]))
        i = 0
        while left > 0:
            n = min(left, int(lengths[i % len(lengths)]))
            if 0 < left - n < lo:
                n = left
            runs.append((kind, n))
            left -= n
            i += 1
    return runs


def run_frames(kind: str, n: int, rng: np.random.Generator, mix: dict) -> list:
    """``n`` frames of one run of ``kind`` with inputs drawn from ``rng``."""
    keys, dx = (False,) * 4, 0.0
    if kind in ("walk", "walk_look"):
        held = rng.choice(4, size=int(rng.integers(mix["keys_held"][0],
                                                   mix["keys_held"][1] + 1)), replace=False)
        keys = tuple(bool(i in held) for i in range(4))
    if kind in ("look", "walk_look"):
        lo, hi = mix["mouse_dx"]
        dx = float(rng.integers(lo, hi + 1)) * (1.0 if rng.random() < 0.5 else -1.0)
    return [(keys, dx, dx != 0.0)] * n


class Script:
    """The frames of a run of ``mix`` at ``seed``: ``warmup`` (a list) and
    ``window()``, an endless iterator of calls (lists of frames)."""

    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, seed
        rng = np.random.default_rng([seed, 1])
        self.warmup = [f for kind, n in mix["warmup"] for f in run_frames(kind, n, rng, mix)]
        self.runs = cycle_runs(mix)

    def cycle(self, index: int) -> list:
        rng = np.random.default_rng([self.seed, 2, index])
        order = rng.permutation(len(self.runs))
        return [f for i in order for f in run_frames(*self.runs[i], rng, self.mix)]

    def frames(self) -> Iterator:
        index = 0
        while True:
            yield from self.cycle(index)
            index += 1

    def window(self) -> Iterator[list]:
        per = self.mix["frames_per_call"]
        frames = self.frames()
        while True:
            yield [next(frames) for _ in range(per)]

    def warmup_calls(self) -> list:
        per = self.mix["frames_per_call"]
        return [self.warmup[i:i + per] for i in range(0, len(self.warmup), per)]
