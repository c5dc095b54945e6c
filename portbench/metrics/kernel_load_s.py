"""Seconds the run spent loading the built kernel libraries and binding
their entries: the program's span ``kernels.load``
(mirror_maze_tpu_torch/kernels.py), summed over the run in its process;
host clock. An nvcc build (the span ``kernels.build``, made only in a
checkout's first run) is left out, so the reading does not hang on whether
the run had to build. None where the program keeps no spans."""


def read(rec):
    from mirror_maze_tpu_torch.utils import profiling

    totals = getattr(profiling, "totals", None)
    if totals is None:
        return None
    return totals().get("kernels.load", {}).get("seconds", 0.0)
