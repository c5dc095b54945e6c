"""The BVH walk kernel's share of its roofline, in %: the least time a launch
could take (portbench/roofline/bvh_walk.py: the larger of its float32
operations over 67 TFLOP/s and its bytes over 3.35 TB/s, a frame's mean over
its segments, counted by the reference route ``segments`` on a seeded sample
of the window's own rays and scaled to the frame) over the kernel's mean
device time a launch in the traced window (``by_kernel`` entries named
``bvh_walk``). None where the window launched no walk."""

from .segment_kernels import PATTERNS, share

ROOFLINE = "bvh_walk"


def read(rec):
    return share(rec, ROOFLINE, PATTERNS[ROOFLINE])
