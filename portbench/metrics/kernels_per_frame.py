"""Device kernels in the traced window over its frames, from the
profiler's kernel records."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("kernels"):
        return None
    return t["kernels"] / t["frames"]
