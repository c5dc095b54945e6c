"""Seconds of the graphs' warm-up: the self time of the program's spans
``graph.eager`` (a kind's eager first frame) and ``graph.capture`` (its
CUDA graph capture) in mirror_maze_tpu_torch/runtime/graph.py, summed over
the run in its process, so the kernel libraries' load and build inside
them (``kernel_load_s``) are left out; host clock. None where the program
keeps no spans."""

SPANS = ("graph.eager", "graph.capture")


def read(rec):
    from mirror_maze_tpu_torch.utils import profiling

    totals = getattr(profiling, "totals", None)
    if totals is None:
        return None
    t = totals()
    return sum(t[k]["self_seconds"] for k in SPANS if k in t)
