"""Host milliseconds a frame inside the step calls of the window's untraced
part (all of it in an untraced run, its first half in a traced one, so the
profiler's own cost stays out): the time in each call into the port (input
upload, the graph replays' launch, the state's copies and the display's ops
enqueued), summed and divided by those calls' frames."""


def read(rec):
    return rec["host_s"] * 1e3 / rec["host_frames"] if rec["host_frames"] else None
