"""The normal draw's share of its roofline, in %: the least time a launch
could take (portbench/roofline/normal_draw.py: the larger of its threefry
hashes' int32 operations over 33.45 Tops/s and its bytes over 3.35 TB/s for
a frame's wavefront) over the mean device time a launch of the threefry
kernel's normal instance (source IOTA, output NORMAL: ``threefry_kernel<0,
3>``) in the traced window. None where the window drew no normals."""

from .segment_kernels import PATTERNS, share

ROOFLINE = "normal_draw"


def read(rec):
    return share(rec, ROOFLINE, PATTERNS[ROOFLINE])
