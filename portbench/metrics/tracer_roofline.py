"""The tracer kernel's share of its roofline, in %: the least time a launch
could take (the larger of its float32 operations over 67 TFLOP/s and its
bytes over 3.35 TB/s, portbench/roofline/tracer.py, counted on the plain
tracer's statistics of a seeded sample of the window's own rays and scaled
to a launch) over the kernel's mean device time a launch in the traced
window."""

ROOFLINE = "tracer"


def read(rec):
    t, r = rec.get("trace"), rec.get("rooflines", {}).get(ROOFLINE)
    if not t or not r or not t.get("tracer_launches"):
        return None
    ms = t["tracer_s"] * 1e3 / t["tracer_launches"]
    return r["bound_ms"] / ms * 100.0
