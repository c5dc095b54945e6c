"""Device resolution: the CUDA card by default, the CPU only on request.

There is no silent fallback. ``device=None`` means ``cuda`` and raises when
no card is present, so a run that was meant for the GPU can never quietly
measure the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as given.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; mirror_maze_tpu_torch runs on the CUDA "
            "card by default — pass device='cpu' to run on the CPU"
        )
    return dev
