"""Present: feedback blur + 8-bit quantization in one pass over the
chunk-major screen (counterpart of the JAX package's ``render/present.py``).

On a CUDA tensor ``present`` launches the hand-written kernel
(csrc/present.cu: a thread per strip of a chunk, 16-byte loads and stores
at chunk width 4, no integer division); on a CPU tensor it runs
``present_plain``, the same function in PyTorch (render/accumulate.py
feedback_blur_cm + quantize_8bit), which the kernel matches bitwise.

With ``halo_top`` and ``halo_bot`` the screen is a row band of a taller
screen (parallel/shard.py): the band's top pixel row blurs with the row
above it, ``halo_top``, and its bottom row with ``halo_bot``, each a plain
pixel row [width * 3] = [Cx, cw, 3] of float32 on the band's device. The
outermost bands pass their own edge row, which is the single screen's clamp,
so the bands put together are bitwise the whole screen's present.
"""

from __future__ import annotations

import torch

from .. import kernels
from .accumulate import feedback_blur_cm, quantize_8bit


def _check_halos(cm, screen_cfg, halo_top, halo_bot) -> None:
    if (halo_top is None) != (halo_bot is None):
        raise ValueError("present takes both halo rows or neither")
    for name, h in (("halo_top", halo_top), ("halo_bot", halo_bot)):
        if h is not None and (h.numel() != screen_cfg.width * 3 or h.dtype != torch.float32
                              or h.device != cm.device):
            raise ValueError(f"{name} must be a float32 pixel row of {screen_cfg.width * 3} "
                             f"floats on {cm.device}, got {h.dtype} {tuple(h.shape)} on "
                             f"{h.device}")


def present_plain(cm: torch.Tensor, screen_cfg, quantize: bool,
                  halo_top: torch.Tensor | None = None,
                  halo_bot: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of the present kernel, both variants."""
    _check_halos(cm, screen_cfg, halo_top, halo_bot)
    out = feedback_blur_cm(cm, screen_cfg, halo_top, halo_bot)
    return quantize_8bit(out) if quantize else out


def present(cm: torch.Tensor, screen_cfg, quantize: bool,
            halo_top: torch.Tensor | None = None,
            halo_bot: torch.Tensor | None = None) -> torch.Tensor:
    """Blur (+ quantize) the chunk-major screen [C, cw*cw*3] into a new
    tensor: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor. A launch with halo rows is counted as ``present_halo``."""
    want = (screen_cfg.total_chunks, screen_cfg.pixels_per_chunk * 3)
    if tuple(cm.shape) != want or cm.dtype != torch.float32:
        raise ValueError(f"present takes a float32 {want} screen, got "
                         f"{cm.dtype} {tuple(cm.shape)}")
    _check_halos(cm, screen_cfg, halo_top, halo_bot)
    if cm.device.type == "cpu":
        return present_plain(cm, screen_cfg, quantize, halo_top, halo_bot)
    if cm.device.type != "cuda":
        raise ValueError(f"present runs on cuda or cpu tensors, got {cm.device}")
    src = cm.contiguous()
    if src.data_ptr() % 16:                 # the kernel reads 16-byte words
        src = src.clone()
    out = torch.empty_like(src)
    halo = halo_top is not None
    if halo:
        halo_top, halo_bot = halo_top.contiguous(), halo_bot.contiguous()
    with torch.cuda.device(cm.device):      # the launch goes to this device's stream
        kernels.launch(
            "present", src.data_ptr(), out.data_ptr(),
            halo_top.data_ptr() if halo else None, halo_bot.data_ptr() if halo else None,
            screen_cfg.chunks_x, screen_cfg.chunks_y, screen_cfg.chunk_width,
            int(bool(quantize)), count_as="present_halo" if halo else None,
        )
    return out
