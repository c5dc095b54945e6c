"""Engine state and per-frame inputs (counterpart of the JAX package's
``runtime/state.py``).

Everything the reference keeps across frames — camera position, quaternion
and yaw half-angle (`main.rs:735-741`), the frame counter, the shuffled
chunk queue and the screen — lives in one tuple of device tensors that the
step threads through, so the frame loop never waits on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import EngineConfig
from ..device import resolve_device
from ..ops import prng
from ..ops import quat as quat_ops
from ..render.camera import Camera, make_camera
from ..render.scheduler import init_permutation


class EngineState(NamedTuple):
    cam_center: torch.Tensor  # [3] float32
    quat: torch.Tensor        # [4] float32 (x, y, z, w)
    half_theta: torch.Tensor  # [] float32 — yaw half-angle (`main.rs:741`)
    screen: torch.Tensor      # [C, cw*cw*3] float32 chunk-major screen
    perm: torch.Tensor        # [C] int32 shuffled chunk ids
    cursor: torch.Tensor      # [] int32
    key: torch.Tensor         # [2] int64 holding a uint32 threefry key
    frame: torch.Tensor       # [] int32 frame counter

    def camera(self, cfg: EngineConfig) -> Camera:
        vh = cfg.camera.viewport_height
        aspect = cfg.screen.width / cfg.screen.height
        f32 = dict(dtype=torch.float32, device=self.cam_center.device)
        return Camera(
            center=self.cam_center,
            rotation=self.quat,
            focal=torch.tensor(cfg.camera.focal_length, **f32),
            viewport=torch.tensor([vh * aspect, vh], **f32),
        )


class FrameInputs(NamedTuple):
    """Per-frame user input, held on the host (it comes from the host):
    keys (A, S, D, W) as the reference's keycodes 0/1/2/13 (`main.rs:786-815`),
    the accumulated mouse delta-x, and whether the mouse moved
    (`main.rs:922-928`)."""

    keys: tuple               # 4 bools: A, S, D, W
    mouse_dx: float
    rot_updated: bool

    @staticmethod
    def idle() -> "FrameInputs":
        return FrameInputs(keys=(False,) * 4, mouse_dx=0.0, rot_updated=False)

    @staticmethod
    def make(a=False, s=False, d=False, w=False, mouse_dx=0.0) -> "FrameInputs":
        return FrameInputs(keys=(bool(a), bool(s), bool(d), bool(w)),
                           mouse_dx=float(mouse_dx),
                           rot_updated=mouse_dx != 0.0)


def init_state(cfg: EngineConfig, seed: int = 0, device=None) -> EngineState:
    """The first frame's state (the JAX package's init_state), on ``device``
    (None = the CUDA card)."""
    dev = resolve_device(device)
    key = prng.PRNGKey(seed, device=dev)
    pkey, key = prng.split(key)
    cam = make_camera(cfg.camera, cfg.screen.width / cfg.screen.height, dev)
    return EngineState(
        cam_center=cam.center,
        quat=cam.rotation,
        half_theta=quat_ops.half_theta_of(cam.rotation),
        screen=torch.zeros(
            (cfg.screen.total_chunks, cfg.screen.pixels_per_chunk * 3),
            dtype=torch.float32, device=dev,
        ),
        perm=init_permutation(pkey, cfg.screen),
        cursor=torch.tensor(0, dtype=torch.int32, device=dev),
        key=key,
        frame=torch.tensor(0, dtype=torch.int32, device=dev),
    )


_DTYPES = dict(cam_center=torch.float32, quat=torch.float32,
               half_theta=torch.float32, screen=torch.float32,
               perm=torch.int32, cursor=torch.int32, key=torch.int64,
               frame=torch.int32)


def from_reference_state(arrays, device=None) -> EngineState:
    """An EngineState from the JAX package's state arrays — a dict of NumPy
    arrays with the EngineState fields, which is what its ``save_state``
    ``.npz`` holds (the uint32 key words become int64 values)."""
    dev = resolve_device(device)
    missing = [k for k in EngineState._fields if k not in arrays]
    if missing:
        raise ValueError(f"state arrays lack field(s) {missing}")
    fields = {}
    for name, dtype in _DTYPES.items():
        a = np.asarray(arrays[name])
        if name == "key":
            a = a.astype(np.uint32).astype(np.int64)
        fields[name] = torch.from_numpy(np.array(a)).to(dtype=dtype, device=dev)
    return EngineState(**fields)
