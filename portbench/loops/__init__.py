"""The driven loops, one module a loop shape: a traffic mix names its loop
(``"loop"`` in ``portbench/traffic/<mix>.json``) and the run imports
``portbench/loops/<loop>.py`` by that name. A loop module has

- ``make_call(scene, cfg)``: the port's entry the loop drives, as
  ``call(state, frames) -> (state, display frame)``;
- ``warm_up(run)``: the mix's warm-up calls, each graph the mix uses
  captured there;
- ``drive(run)``: the window, closed after the call that reaches
  ``run.seconds``.

Both step the ``Run`` below and fill in what the metric readers and the
reference read. A loop shape the benchmark does not have yet (an open loop
of several clients, the offline renderer) is a new module here.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable


@dataclasses.dataclass
class Run:
    """One run of a cell as its loop steps it."""

    call: Callable
    state: Any
    script: Any            # portbench/traffic.py Script
    clock: Any             # portbench/run.py Clock
    seconds: float
    trace: bool
    stepped: list = dataclasses.field(default_factory=list)   # every frame stepped
    checks: dict = dataclasses.field(default_factory=dict)    # calls the reference checks
    frames: int = 0        # frames of the window
    window_s: float = 0.0
    host_s: float = 0.0    # host seconds inside the untraced window's step calls
    host_frames: int = 0   # the frames of those calls
    trace_rec: dict | None = None


def find(name: str):
    return importlib.import_module(f"portbench.loops.{name}")
