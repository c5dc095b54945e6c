"""The share, in %, of the tracer kernel's lane slots that tested a record
in the two-term axis form (its pass 1 over axis-aligned quads): the
kernel's own counters (mirror_maze_tpu_torch/render/fused_tracer.py
``counters``), ``axis_tests`` over ``tests_issued``, summed over every
launch of the run (the warm-up's and the window's) and read once at its
end, in the run's process. None where the program keeps no such counter,
or ran on no card."""


def read(rec):
    from mirror_maze_tpu_torch.render import fused_tracer

    counters = getattr(fused_tracer, "counters", None)
    if counters is None or rec["device"].type != "cuda":
        return None
    c = counters(rec["device"])
    if "axis_tests" not in c or not c["tests_issued"]:
        return None
    return 100.0 * c["axis_tests"] / c["tests_issued"]
