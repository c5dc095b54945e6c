"""The plain reference the benchmark holds the port's outputs against:
NumPy and torch only, nothing of the port or of JAX.

A configuration file names its route, ``"reference": "<route>"``: the
module ``portbench/reference/<route>.py`` that traces its rays the way the
port's route for that configuration does. ``check.py`` works out every
frame and the glue around the rays, and calls the route for the rest. A
route module has

- ``build(cfg, device)``: the scene of the configuration's ``engine`` group
  on ``device``, with the collision leaf boxes ``leaf_min`` / ``leaf_max``
  (float32 NumPy [L, 3]) that ``sim.Engine`` reads;
- ``trace(scene, ori, dirs, ray_ids, frames, anchor, tc, dtype, budget,
  stats=None)``: the light [R, 3], in ``dtype``, of rays (ori, dirs) [R, 3]
  at positions ``ray_ids`` (int64 [R]) of their frames' wavefronts.
  ``frames`` is [(sim.Frame, n)]: the rays are those frames' runs of n rays
  in order (a frame's ``seed`` and ``tkey`` are its draws). ``anchor`` is
  the frames' camera centre (float32 [3]), ``tc`` the ``tracer`` group,
  ``budget`` the elements of one [rays, records] intermediate it may hold at
  once. Where the route counts its work, ``stats`` (a dict) gains its
  counts, added to what it holds.
"""

import importlib.util
import re
import sys

ROUTE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def route_module(cfg_file: dict) -> str:
    """The module of the route that a configuration file names, found but
    not imported (so a run can look before its set-up at no cost); a
    ValueError naming the route where there is no such module."""
    name = cfg_file.get("reference")
    if not isinstance(name, str) or not ROUTE_NAME.match(name):
        raise ValueError(f"configuration {cfg_file.get('name')!r} names no reference route: "
                         f"{name!r}")
    module = f"{__name__}.{name}"
    if module not in sys.modules and importlib.util.find_spec(module) is None:
        raise ValueError(f"no reference route {name!r}: no module {module}")
    return module
