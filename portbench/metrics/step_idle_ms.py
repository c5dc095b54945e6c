"""Device-idle milliseconds a frame inside the step calls of the traced
window: the idle gaps of the device timeline whose midpoint lies inside the
benchmark's ``pb.step`` span (the ``step`` entry of the trace's idle gaps),
over the traced frames. ``pb.step`` holds one call of the program's
``make_scan_step`` and the loop's list of the frames' inputs. None where
the run was not traced."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("frames"):
        return None
    gaps = dict(t["breakdown"]["idle_gaps"])
    return gaps.get("step", 0.0) * 1e3 / t["frames"]
