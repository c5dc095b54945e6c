"""Milliseconds a frame over the whole window: its length on the host clock
(it ends when the last call's display frame is on the host, which follows
every frame's device work) over the frames it stepped."""


def read(rec):
    return rec["window_s"] * 1e3 / rec["frames"] if rec["frames"] else None
