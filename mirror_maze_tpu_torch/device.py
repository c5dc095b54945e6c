"""Device resolution: the CUDA card by default, the CPU only on request;
the kernel wrappers' dispatch (``on_card``); the check of a live-id list
(``check_live_list``); and the step's device constants (``constant``).

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


def on_card(t: torch.Tensor, name: str) -> bool:
    """Where a kernel wrapper dispatches: True for a CUDA tensor (the
    kernel), False for a CPU one (the plain version); raises on any other
    device, so that nothing runs a plain version in a kernel's place."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")
    return True


def check_live_list(ids: torch.Tensor, count: torch.Tensor, n_rays: int, device) -> None:
    """Raise unless (ids, count) is a live-id list for ``n_rays`` rays on
    ``device``: ids contiguous int32 [n_rays], count int32 [1]."""
    for name, x, shape in (("ids", ids, (n_rays,)), ("count", count, (1,))):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32 or x.device != device
                or tuple(x.shape) != shape or not x.is_contiguous()):
            got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if isinstance(x, torch.Tensor)
                   else type(x).__name__)
            raise ValueError(f"a live-id list's {name} must be contiguous int32 {shape} on "
                             f"{device}, got {got}")


_constants: dict = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and shared: READ-ONLY. The step body takes its
    constants from here, so that after its first frame it copies nothing
    from the host, which a CUDA graph capture (runtime/graph.py) forbids."""
    key = (values, dtype, torch.device(device))
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
