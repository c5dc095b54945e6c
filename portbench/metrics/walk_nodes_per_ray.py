"""Nodes visited a walked ray: the BVH walk kernel's own counters
(mirror_maze_tpu_torch/render/intersect.py ``counters``), ``walk_nodes``
(interior and leaf nodes visited) over ``walk_rays``, summed over every
launch of the run and read once at its end, in the run's process. None
where the program keeps no such counters, ran on no card or walked no ray."""


def read(rec):
    from mirror_maze_tpu_torch.render import intersect

    counters = getattr(intersect, "counters", None)
    if counters is None or rec["device"].type != "cuda":
        return None
    c = counters(rec["device"])
    return c["walk_nodes"] / c["walk_rays"] if c.get("walk_rays") else None
