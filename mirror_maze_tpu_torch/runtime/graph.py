"""The engine step as captured CUDA graphs (the counterpart of the JAX
package's ``jax.jit`` of its step and scan, state donated,
``runtime/step.py make_step`` / ``make_scan_step``).

A frame of the eager step is ~1,500 kernel launches, and the host issues
them slower than the card runs them. Here the step body of one input kind
(a frame that rotates, or one that does not: the JAX package's ``lax.cond``)
is captured once into a ``torch.cuda.CUDAGraph`` and every later frame of
that kind is ONE replay:

- the state lives in static buffers that each graph reads and, at its end,
  overwrites with the new state; the frame's input row (runtime/step.py
  ``upload_inputs``) is copied into a static input buffer before the replay;
- the first frame of a kind that has no graph yet runs eagerly, on the
  caller's state, as the frame it is (it builds the kernels, fills the
  tracer's launch geometry and the step's device constants), and the kind
  is captured after it; so the kernel launch counts read one per frame
  stepped, whatever the route;
- the two graphs of a runner share one memory pool: they never run at once,
  and nothing a graph allocates is read after it ends (its result is copied
  into the static buffers), so either may follow the other;
- each runner brings its own pair of tracer work counters
  (render/fused_tracer.py ``work_counters``), and the counts of the launches
  a capture recorded are added to ``kernels.launches`` on every replay;
- a captured body is told that it runs on the runner's own buffers
  (``state_owned``), so it writes the frame's rows into the screen buffer in
  place where an eager frame writes them into a copy.

The functional contract of the eager step holds: a state passed in is
copied into the static buffers (unless it is the one the last call handed
back, unchanged), and the state handed back is a copy, so no tensor a
caller holds is ever written by a later call. A capture that fails raises;
there is no switch that turns graphs off. The eager route is the step body
itself (``make_step_fn`` / ``make_scan_step_fn``).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import weakref
from typing import Callable

import torch

from .. import kernels
from ..render import fused_tracer
from ..utils.profiling import span


_owner = threading.local()


def state_owned() -> bool:
    """Whether the step body running on this thread was handed a graph
    runner's static buffers (it is being captured): the body may then write
    the screen's new rows into the state's screen itself, since nothing
    reads the old one after the frame (its new state is copied back into the
    buffers at the graph's end). Anywhere else the state is the caller's and
    is never written."""
    return getattr(_owner, "depth", 0) > 0


@contextlib.contextmanager
def _owning():
    _owner.depth = getattr(_owner, "depth", 0) + 1
    try:
        yield
    finally:
        _owner.depth -= 1


@contextlib.contextmanager
def _gc_paused():
    """No cyclic garbage collection during a capture: a collection there can
    free a dead graph of an earlier runner, and destroying it is a CUDA call
    that invalidates the capture in progress (the launch after it fails with
    cudaErrorStreamCaptureInvalidated). torch.cuda.graph no longer collects
    before a capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _flatten(state) -> list:
    """The tensors of a state (an EngineState, or a ShardedEngineState whose
    fields are tuples over the bands), in field order."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for field in state for t in _flatten(field)]


def _unflatten(template, leaves):
    """A state shaped as ``template`` from its tensors in field order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        items = [build(f) for f in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)

    return build(template)


def call_plan(kinds, captured) -> list:
    """What a call does per frame, given each frame's kind and the kinds
    already captured: ``("eager", kind)`` for the first frame of a kind that
    has no graph yet (the kind is captured after it), ``("replay", kind)``
    for the rest."""
    have, plan = set(captured), []
    for kind in kinds:
        plan.append(("replay" if kind in have else "eager", kind))
        have.add(kind)
    return plan


class StepGraphs:
    """The captured graphs of one step body on one CUDA device.

    ``body(state, input_row, rotate) -> state`` must hold no host value: no
    ``.item()``, no host copy, no branch on a tensor. Statistics of the
    runner: ``capture_s`` (seconds spent capturing), ``pool_bytes`` (device
    memory the captures reserved), ``replays`` and ``eager_frames``, and
    ``copies`` (device-to-device copies it made: input rows, states copied
    in and handed back). Its spans (utils/profiling.py): ``step.replays``
    around a call's frames, one a call, with ``step.copy_in``,
    ``graph.eager`` (a kind's eager first frame) and ``graph.capture``
    inside, then ``step.hand_back`` (the state's clones)."""

    def __init__(self, body: Callable, device):
        self._body = body
        self.device = torch.device(device)
        self._graphs: dict = {}     # kind -> (CUDAGraph, Counter of its launches)
        self._pool = None
        self._static: list | None = None     # the state's tensors every graph reads and writes
        self._static_in: torch.Tensor | None = None
        self._work: torch.Tensor | None = None
        self._handed = None         # (weak refs, versions) of the state last handed back
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self.eager_frames = 0
        self.copies = 0

    @property
    def kinds(self) -> tuple:
        """The input kinds captured so far."""
        return tuple(sorted(self._graphs))

    def _is_handed(self, leaves) -> bool:
        """``leaves`` are the tensors of the state this runner handed back
        last, unchanged since: the static buffers hold them already."""
        if self._handed is None:
            return False
        refs, versions = self._handed
        return (len(leaves) == len(refs)
                and all(a is r() and a._version == v for a, r, v in zip(leaves, refs, versions)))

    def _copy_in(self, leaves) -> None:
        if len(leaves) != len(self._static):
            raise ValueError(f"a state of {len(leaves)} tensors, the graphs hold {len(self._static)}")
        with span("step.copy_in"):
            for s, t in zip(self._static, leaves):
                if t.shape != s.shape or t.dtype != s.dtype or t.device != s.device:
                    raise ValueError(f"a state tensor {t.dtype} {tuple(t.shape)} on {t.device} "
                                     f"where the graphs hold {s.dtype} {tuple(s.shape)} on "
                                     f"{s.device}")
                if t is not s:
                    s.copy_(t)
                    self.copies += 1

    def _capture(self, kind, template, leaves, row) -> None:
        dev = self.device
        if self._static is None:
            self._static = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in leaves]
            self._static_in = torch.empty_like(row)
            self._work = torch.zeros(2, dtype=torch.int32, device=dev)
            self._pool = torch.cuda.graph_pool_handle()
        fused_tracer.counter_buffer(dev)     # allocated outside the capture
        graph = torch.cuda.CUDAGraph()
        with (span("graph.capture") as captured, kernels.counting_capture() as counted,
              fused_tracer.work_counters(self._work), _owning(), _gc_paused()):
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(dev)
                new = _flatten(self._body(_unflatten(template, self._static), self._static_in,
                                          kind))
                for s, t in zip(self._static, new):
                    if t is not s:
                        s.copy_(t)
                del new
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.capture_s += captured.seconds
        self._graphs[kind] = (graph, counted)

    def run(self, state, rows: torch.Tensor, kinds) -> object:
        """The state after one frame per entry of ``kinds`` (bools: the
        frame rotates), frame i reading input row ``rows[i]`` (on this
        device). Returns a state of new tensors."""
        leaves = _flatten(state)
        if rows.shape[0] != len(kinds):
            raise ValueError(f"{rows.shape[0]} input rows for {len(kinds)} frames")
        if self._static_in is not None and rows.shape[1:] != self._static_in.shape:
            raise ValueError(f"input rows of {tuple(rows.shape[1:])}, the graphs read "
                             f"{tuple(self._static_in.shape)}")
        in_static = self._is_handed(leaves)
        self._handed = None
        cur = self._static if in_static else leaves
        with span("step.replays"):
            for i, (what, kind) in enumerate(call_plan(kinds, self._graphs)):
                if what == "eager":
                    with span("graph.eager"):
                        cur = _flatten(self._body(_unflatten(state, cur), rows[i], kind))
                    in_static = False
                    self.eager_frames += 1
                    self._capture(kind, state, cur, rows[i])
                    continue
                if not in_static:
                    self._copy_in(cur)
                    cur, in_static = self._static, True
                graph, counted = self._graphs[kind]
                self._static_in.copy_(rows[i])
                graph.replay()
                kernels.add_launches(counted)
                self.replays += 1
                self.copies += 1
        with span("step.hand_back"):
            if in_static:
                out = [t.clone() for t in self._static]
                self.copies += len(out)
                self._handed = ([weakref.ref(t) for t in out], [t._version for t in out])
            else:
                static = {id(t) for t in self._static or ()}
                out = [t.clone() if id(t) in static else t for t in cur]
        return _unflatten(state, out)


class StepRunner:
    """A step body bound to a scene, run for a list of frames: as graph
    replays (``StepGraphs``, one per device) where the state's tensors are
    all on one CUDA device and ``graphs`` is set (the body is free of host
    reads), else as an eager loop of the body (the CPU, bands on several
    devices)."""

    def __init__(self, body: Callable, graphs: bool):
        self._body = body
        self._use_graphs = graphs
        self.graphs: dict = {}      # device -> StepGraphs

    def graphed(self, state) -> bool:
        """Whether a call on ``state`` replays graphs."""
        devs = {t.device for t in _flatten(state)}
        return self._use_graphs and len(devs) == 1 and next(iter(devs)).type == "cuda"

    def __call__(self, state, rows: torch.Tensor, kinds):
        """The state after frame i of ``kinds`` (bools: it rotates) read
        input row ``rows[i]``, for every i; ``rows`` on the device of the
        state's first tensor."""
        if self.graphed(state):
            dev = _flatten(state)[0].device
            if dev not in self.graphs:
                self.graphs[dev] = StepGraphs(self._body, dev)
            return self.graphs[dev].run(state, rows, kinds)
        for i, rotate in enumerate(kinds):
            state = self._body(state, rows[i], rotate)
        return state
