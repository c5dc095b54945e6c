"""The share, in %, of the tracer kernel's lane slots that tested a record a
live ray needed: the kernel's own counters (mirror_maze_tpu_torch/render/
fused_tracer.py ``counters``), ``tests_needed`` over ``tests_issued``,
summed over every launch of the run (the warm-up's and the window's) and
read once at its end, in the run's process. None where the program keeps
no such counters, or ran on no card."""


def read(rec):
    from mirror_maze_tpu_torch.render import fused_tracer

    counters = getattr(fused_tracer, "counters", None)
    if counters is None or rec["device"].type != "cuda":
        return None
    c = counters(rec["device"])
    return 100.0 * c["tests_needed"] / c["tests_issued"] if c["tests_issued"] else None
