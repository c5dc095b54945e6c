"""The shade kernel's share of its roofline, in %: the least time a launch
could take (portbench/roofline/shade.py: its bytes over 3.35 TB/s, a frame's
mean over its segments, counted by the reference route ``segments`` on a
seeded sample of the window's own rays and scaled to the frame) over the
kernel's mean device time a launch in the traced window (``by_kernel``
entries named ``shade_kernel``). None where the window launched no shade."""

from .segment_kernels import PATTERNS, share

ROOFLINE = "shade"


def read(rec):
    return share(rec, ROOFLINE, PATTERNS[ROOFLINE])
