"""Scripted frame loop (counterpart of the JAX package's ``runtime/loop.py``
``run_scripted``)."""

from __future__ import annotations

from typing import Iterable

from ..config import EngineConfig
from ..render.scenebuf import DeviceScene
from .state import EngineState, FrameInputs, init_state
from .step import make_step


def run_scripted(
    scene: DeviceScene,
    cfg: EngineConfig,
    inputs: Iterable[FrameInputs] | None = None,
    n_frames: int = 64,
    seed: int = 0,
    state: EngineState | None = None,
):
    """Run the given per-frame inputs (``n_frames`` idle frames if None) on
    the scene's device. Returns (final_state, last_frame_u8 as NumPy); only
    the final frame is fetched."""
    step = make_step(scene, cfg)
    st = state if state is not None else init_state(cfg, seed, device=scene.planes.device)
    script = [FrameInputs.idle()] * n_frames if inputs is None else list(inputs)
    frame = None
    for inp in script:
        st, frame = step(st, inp)
    if frame is not None:
        frame = frame.cpu().numpy()
    return st, frame
