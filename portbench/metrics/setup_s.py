"""Seconds from the start of the process to the first timed frame: imports,
the kernels' load (their build in a checkout's first run), the scene's
build and upload, the engine's state, the warm-up with its graph captures;
host clock, ended by a synchronize."""


def read(rec):
    return rec["setup_s"]
