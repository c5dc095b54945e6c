"""The share, in %, of the threads the BVH walk's launches started that
walked a ray: the walk kernel's own counters (mirror_maze_tpu_torch/render/
intersect.py ``counters``), ``walk_rays`` over ``walk_threads``, summed over
every launch of the run (warm-up and window) and read once at its end, in
the run's process. Each segment's grid is sized for the whole wavefront
today, so the later segments' grids are mostly idle; a grid sized to the
rays alive moves it up, and so does walking rays the shading has ended
(read it beside ``frame_ms``). None where the program keeps no such
counters, ran on no card or started no walk."""


def read(rec):
    from mirror_maze_tpu_torch.render import intersect

    counters = getattr(intersect, "counters", None)
    if counters is None or rec["device"].type != "cuda":
        return None
    c = counters(rec["device"])
    return 100.0 * c["walk_rays"] / c["walk_threads"] if c.get("walk_threads") else None
