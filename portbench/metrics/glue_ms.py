"""Device milliseconds a frame of every operation but the tracer kernel
and the copies to and from the host: frame_setup, camera_rays, resolve, the
present, the turn's ops, the graphs' copies. From the traced window's
device records."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("kernels"):
        return None
    return t["glue_s"] * 1e3 / t["frames"]
