"""The frozen operation and byte counts of the port's kernels, one module a
kernel, and the chip's peaks they are held against."""

# Published NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W limit):
# float32 outside the tensor cores, and HBM3.
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
