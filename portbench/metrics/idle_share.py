"""The share of the traced window, in %, in which no operation runs on the
device (kernels, copies and sets on the profiler's device timeline)."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("window_s") or not t.get("busy_s"):
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
