"""Device milliseconds a frame of the segment path's glue: every device
operation of the traced window but the host copies (the trace's ``glue_s``;
no fused tracer runs here) less the three segment kernels (``by_kernel``
entries of the walk, the shade and the normal draw): frame_setup,
camera_rays, resolve, the present, the segment keys' ``fold_in``, the path
state's fills and copies, the graphs' copies. None where the run was not
traced or its window launched no segment kernel."""

from .segment_kernels import PATTERNS, matching


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("kernels"):
        return None
    segment = [k for p in PATTERNS.values() for k in matching(t.get("by_kernel", {}), p)]
    if not segment:
        return None
    return (t["glue_s"] - sum(k["seconds"] for k in segment)) * 1e3 / t["frames"]
