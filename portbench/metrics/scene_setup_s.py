"""Seconds of the scene's build (maze, walls) and upload (the tracer's
tables, the collision boxes), ended by a synchronize; host clock."""


def read(rec):
    return rec["scene_setup_s"]
