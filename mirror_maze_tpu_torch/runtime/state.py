"""Engine state and per-frame inputs (counterpart of the JAX package's
``runtime/state.py``).

Everything the reference keeps across frames — camera position, quaternion
and yaw half-angle (`main.rs:735-741`), the frame counter, the shuffled
chunk queue and the screen — lives in one tuple of device tensors that the
step threads through, so the frame loop never waits on the host.

``save_state`` / ``load_state`` checkpoint it in the JAX package's ``.npz``
layout (one array per field, the key as its two uint32 words), so a
checkpoint written by either package resumes in the other, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import EngineConfig
from ..device import constant, resolve_device
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
        dev = self.cam_center.device
        return Camera(
            center=self.cam_center,
            rotation=self.quat,
            focal=constant(cfg.camera.focal_length, torch.float32, dev),
            viewport=constant((vh * aspect, vh), torch.float32, dev),
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


def from_reference_sharded_state(arrays, devices=None):
    """A ``parallel.shard.ShardedEngineState`` from the JAX package's band
    engine state: a dict of NumPy arrays with its fields in the gathered
    layout (replicated camera fields and frame counter, ``screen`` [C,
    cw*cw*3] and ``perm`` [C] with the bands stacked, ``cursor`` [n],
    ``key`` [n, 2]). Band i goes to ``devices[i]`` (None = one band on the
    CUDA card); the list must name as many devices as the state has bands."""
    from ..parallel.shard import ShardedEngineState, check_devices

    devs = check_devices(devices)
    missing = [k for k in EngineState._fields if k not in arrays]
    if missing:
        raise ValueError(f"state arrays lack field(s) {missing}")
    n = int(np.asarray(arrays["cursor"]).reshape(-1).shape[0])
    if len(devs) != n:
        raise ValueError(f"the state has {n} bands, the device list {len(devs)} entries")
    screen, perm = np.asarray(arrays["screen"]), np.asarray(arrays["perm"])
    if screen.shape[0] % n or perm.shape[0] != screen.shape[0]:
        raise ValueError(f"a screen of {screen.shape[0]} chunks and a queue of {perm.shape[0]} "
                         f"do not split into {n} bands")
    c_band = screen.shape[0] // n
    bands = []
    for t, dev in enumerate(devs):
        rows = slice(t * c_band, (t + 1) * c_band)
        bands.append(from_reference_state(dict(
            arrays, screen=screen[rows], perm=perm[rows],
            cursor=np.asarray(arrays["cursor"]).reshape(-1)[t],
            key=np.asarray(arrays["key"]).reshape(n, 2)[t]), device=dev))
    return ShardedEngineState.from_bands(bands)


def save_state(path: str, state) -> None:
    """Checkpoint the engine state to a compressed ``.npz`` in the JAX
    package's layout: one array per field, the key as uint32 words. The band
    engine's ShardedEngineState is written in the reference's gathered band
    layout: the replicated camera fields and frame counter once, the screens
    and queues stacked in band order, ``cursor`` [n] and ``key`` [n, 2].
    The reference has no checkpoint; this one restores camera, yaw, screen,
    chunk queue, key and frame counter exactly."""
    host = lambda x: x.detach().cpu().numpy()
    if isinstance(state, EngineState):
        out = {f: host(getattr(state, f)) for f in EngineState._fields}
    else:
        out = {f: host(getattr(state, f)[0]) for f in ("cam_center", "quat", "half_theta",
                                                        "frame")}
        out["screen"] = np.concatenate([host(x) for x in state.screen])
        out["perm"] = np.concatenate([host(x) for x in state.perm])
        out["cursor"] = np.stack([host(x) for x in state.cursor])
        out["key"] = np.stack([host(x) for x in state.key])
    out["key"] = out["key"].astype(np.uint32)
    np.savez_compressed(path, **out)


def check_checkpoint_shapes(path: str, screen_shape: tuple, perm_shape: tuple,
                            cfg: EngineConfig) -> None:
    """The screen and queue shapes of a checkpoint against the config that
    will drive it."""
    want = (cfg.screen.total_chunks, cfg.screen.pixels_per_chunk * 3)
    if tuple(screen_shape) != want:
        hint = (" (spatial [H, W, 3] layout: checkpoint predates the chunk-major screen "
                "and cannot be resumed)" if len(screen_shape) == 3 else "")
        raise ValueError(
            f"checkpoint {path!r} screen shape {tuple(screen_shape)} does not match this "
            f"config's chunk-major {want}{hint}; resume with the resolution/chunking it "
            "was saved under")
    if tuple(perm_shape) != (cfg.screen.total_chunks,):
        raise ValueError(f"checkpoint {path!r} chunk queue {tuple(perm_shape)} does not "
                         f"match this config's {(cfg.screen.total_chunks,)}")


def read_checkpoint(path: str) -> dict:
    """The arrays of a ``save_state`` checkpoint (either package's), all
    fields present or a ValueError."""
    with np.load(path) as z:
        missing = [k for k in EngineState._fields if k not in z]
        if missing:
            raise ValueError(f"checkpoint {path!r} lacks field(s) {missing} — not a "
                             "save_state checkpoint (or from an incompatible version)")
        return {k: np.asarray(z[k]) for k in EngineState._fields}


def load_state(path: str, cfg: EngineConfig | None = None, device=None) -> EngineState:
    """Restore a ``save_state`` checkpoint, written by either package, onto
    ``device`` (None = the CUDA card), bit for bit. With ``cfg`` the
    screen and queue shapes are checked against it. A band engine's
    checkpoint (its cursor has a band axis) needs ``cfg`` and is converted
    to the single layout (``parallel.shard.sharded_to_single``: camera,
    screen and frame exact, the bands' queues interleaved)."""
    dev = resolve_device(device)
    arrays = read_checkpoint(path)
    if arrays["cursor"].ndim == 1:
        if cfg is None:
            raise ValueError(f"checkpoint {path!r} is tile-sharded ({arrays['cursor'].shape[0]} "
                             "bands); pass cfg so it can be converted to the single-chip layout")
        from ..parallel.shard import sharded_to_single

        n = arrays["cursor"].shape[0]
        single = sharded_to_single(from_reference_sharded_state(arrays, ["cpu"] * n), cfg)
        state = EngineState(*(x.to(dev) for x in single))
    else:
        state = from_reference_state(arrays, device=dev)
    if cfg is not None:
        check_checkpoint_shapes(path, state.screen.shape, state.perm.shape, cfg)
    return state
