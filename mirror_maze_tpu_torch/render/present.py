"""Present: feedback blur + 8-bit quantization in one pass over the
chunk-major screen (counterpart of the JAX package's ``render/present.py``).

On a CUDA tensor ``present`` launches the hand-written kernel
(csrc/present.cu); on a CPU tensor it runs ``present_plain``, the same
function in PyTorch (render/accumulate.py feedback_blur_cm +
quantize_8bit), which the kernel matches bitwise.
"""

from __future__ import annotations

import torch

from .. import kernels
from .accumulate import feedback_blur_cm, quantize_8bit


def present_plain(cm: torch.Tensor, screen_cfg, quantize: bool) -> torch.Tensor:
    """The plain PyTorch version of the present kernel."""
    out = feedback_blur_cm(cm, screen_cfg)
    return quantize_8bit(out) if quantize else out


def present(cm: torch.Tensor, screen_cfg, quantize: bool) -> torch.Tensor:
    """Blur (+ quantize) the chunk-major screen [C, cw*cw*3] into a new
    tensor: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    want = (screen_cfg.total_chunks, screen_cfg.pixels_per_chunk * 3)
    if tuple(cm.shape) != want or cm.dtype != torch.float32:
        raise ValueError(f"present takes a float32 {want} screen, got "
                         f"{cm.dtype} {tuple(cm.shape)}")
    if cm.device.type == "cpu":
        return present_plain(cm, screen_cfg, quantize)
    if cm.device.type != "cuda":
        raise ValueError(f"present runs on cuda or cpu tensors, got {cm.device}")
    src = cm.contiguous()
    out = torch.empty_like(src)
    kernels.launch(
        "present", src.data_ptr(), out.data_ptr(), screen_cfg.chunks_x,
        screen_cfg.chunks_y, screen_cfg.chunk_width, int(bool(quantize)),
    )
    return out
