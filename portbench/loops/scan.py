"""A closed loop of one client over ``runtime/step.py make_scan_step``: each
call steps the mix's next ``frames_per_call`` frames (the idle batch of the
play loop and the server), and the call's display frame is copied to the
host with ``.cpu()``, as ``runtime/server.py EngineServer._fetch`` copies
it, before the next call.

A traced run steps the first half of its window without the profiler, for
the host clock's metrics, and traces the calls from there to the window's
end (``pb.window``, with ``pb.step`` and ``pb.fetch`` around each call).
"""

from __future__ import annotations

import time

from .. import trace as tracing


def make_call(scene, cfg):
    from mirror_maze_tpu_torch.runtime.state import FrameInputs
    from mirror_maze_tpu_torch.runtime.step import make_scan_step

    step = make_scan_step(scene, cfg)

    def call(state, frames):
        return step(state, [FrameInputs(keys=k, mouse_dx=dx, rot_updated=r)
                            for k, dx, r in frames])
    call.runner = step.runner
    return call


def warm_up(run) -> None:
    """The mix's warm-up calls; the first is the reference's ``start``."""
    for i, frames in enumerate(run.script.warmup_calls()):
        before = run.state
        run.state, shown = run.call(run.state, frames)
        host = shown.cpu()
        if i == 0:
            run.checks["start"] = dict(first=0, frames=len(frames), before=before,
                                       after=run.state, display=host)
        run.stepped += frames


def drive(run) -> None:
    traced_from = run.seconds / 2 if run.trace else None
    prof = window = None
    span = lambda name: tracing.nothing()  # noqa: E731
    first, traced0 = len(run.stepped), 0
    start = time.perf_counter()
    for frames in run.script.window():
        if traced_from is not None and prof is None and \
                time.perf_counter() - start >= traced_from:
            prof = tracing.start(run.clock.device)
            window = tracing.span("window")
            window.__enter__()
            span, traced0 = tracing.span, run.frames
        before = run.state
        t = time.perf_counter()
        with span("step"):
            run.state, shown = run.call(run.state, frames)
        if prof is None:
            run.host_s += time.perf_counter() - t
            run.host_frames += len(frames)
        with span("fetch"):
            host = shown.cpu()
        run.checks["last"] = dict(first=first, frames=len(frames), before=before,
                                  after=run.state, display=host)
        if any(r for _, _, r in frames):
            run.checks["last_turn"] = run.checks["last"]
        run.stepped += frames
        first += len(frames)
        run.frames += len(frames)
        # A traced run closes its window only after a traced call.
        if time.perf_counter() - start >= run.seconds and (prof is not None or not run.trace):
            break
    run.window_s = time.perf_counter() - start
    if window is not None:
        window.__exit__(None, None, None)
    run.clock.sync()
    if prof is not None:
        run.trace_rec = tracing.stop(prof, run.frames - traced0)
