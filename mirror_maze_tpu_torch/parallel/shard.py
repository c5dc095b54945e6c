"""Rendering over several devices (counterpart of the JAX package's
``parallel/shard.py``).

The reference is one process that maps its step over a mesh of devices.
Here one process drives a LIST of devices, one row band (or one camera and
row tile) each. The list may name a device several times: ``["cuda:0"] * 2``
puts two bands on one card, ``["cpu"] * 4`` is what the CPU tests use, four
cards are four names. ``devices=None`` means one band on the CUDA card and
raises where there is none. Process groups are not used: they belong to the
multi-process multiplayer engine (parallel/multiplayer.py).

- ``make_sharded_renderer``: a batch of cameras x row tiles of full frames,
  every (camera group, tile) on its own device, the scene replicated.
- ``make_sharded_engine`` / ``make_sharded_scan_engine``: the interactive
  engine with the screen cut into row bands. Every band runs its own chunk
  queue over its own rows; the camera simulation is replicated (the same
  inputs give the same arithmetic on every band); the feedback blur reads one
  pixel row from each neighbouring band (``_exchange_halo_rows``), so the
  bands put together are the single screen, bitwise. With
  ``ScreenConfig.pallas_present`` the blur + quantization is the present
  kernel's halo variant (``_present_with_halo``, csrc/present.cu), otherwise
  the plain halo blur (``_blur_with_halo_cm``).

All bands' halo rows are taken from the screens as they stand after the
frame's chunks are written and before any band is presented; the present
returns a new tensor. A copy between two devices is made with
``non_blocking=True`` and no host staging; PyTorch orders it against both
devices' current streams with events, and nothing here synchronizes.

Every intersector runs here. The jnp backends' bvh traversal bounds come
from the concrete scene at the first call (``_lazy_backends``, as the
reference's ``_make_lazy_bounds_step``), and each device's copy of the
scene gets its nearest-hit backend once. ``load_sharded_state`` restores any ``save_state``
checkpoint (runtime/state.py) as bands on a device list.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import EngineConfig, ScreenConfig
from ..device import resolve_device
from ..ops import prng
from ..ops import quat as quat_ops
from ..render.accumulate import (
    cm_to_spatial,
    feedback_blur_cm,
    present_stage,
    to_display,
)
from ..render.camera import Camera, make_camera
from ..render.pipeline import render_pixels, scene_nearest_fn
from ..render.present import present
from ..render.scenebuf import DeviceScene, ScenePrims
from ..runtime.state import (
    EngineState,
    FrameInputs,
    check_checkpoint_shapes,
    from_reference_sharded_state,
    load_state,
    read_checkpoint,
)
from ..runtime.step import advance_to_scatter, frame_inputs


def check_devices(devices, need: int | None = None) -> list:
    """The device list of an engine or renderer (the reference's
    ``make_mesh``): None is one CUDA card (raising without one), names are
    resolved one by one (``"cpu"`` only where the caller names it), and
    ``need`` is the number of entries the caller's layout takes."""
    devs = [resolve_device(None)] if devices is None else [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("the device list is empty")
    if need is not None and len(devs) < need:
        raise ValueError(f"{need} devices needed, {len(devs)} given")
    return devs if need is None else devs[:need]


def replicate_scene(scene: DeviceScene, devices: Sequence) -> list:
    """The scene on each device of the list (the reference replicates it:
    small and read-only); a device named twice shares one copy."""
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = scene if scene.planes.device == d else scene._replace(
                **{f: getattr(scene, f).to(d) for f in scene._fields
                   if isinstance(getattr(scene, f), (torch.Tensor, ScenePrims))})
    return [copies[d] for d in devices]


def batch_cameras(cams: list) -> Camera:
    """Stack single cameras into one batched Camera (leading axis B)."""
    return Camera(*(torch.stack(xs) for xs in zip(*cams)))


def make_sharded_renderer(cfg: EngineConfig, devices=None, n_cam: int = 1,
                          n_tile: int | None = None):
    """The batched full-frame renderer over ``n_cam`` x ``n_tile`` devices
    (``n_tile`` None = all the list holds per camera group).

    Returns ``fn(scene, cams_batched, key) -> (frames, mean_luminance)``:
    ``frames[ci][ti]`` is the tensor [B / n_cam, H / n_tile, W, 3] of camera
    group ``ci`` and row tile ``ti`` on its device (``gather_frames``
    assembles them), ``mean_luminance`` a 0-d tensor on the first device.
    Camera ``i`` of group ``ci`` and tile ``ti`` draws from
    ``fold_in(fold_in(key, ci * 65536 + i), ti)``, as the reference."""
    devs = check_devices(devices)
    if n_tile is None:
        n_tile = len(devs) // n_cam
    devs = check_devices(devs, n_cam * n_tile)
    h, w = cfg.screen.height, cfg.screen.width
    if h % n_tile:
        raise ValueError(f"{h} rows do not split into {n_tile} tiles")
    rows_local = h // n_tile

    scenes_of = _scene_cache(devs)
    backends = _lazy_backends(cfg, None, None)

    def render_tiles(scenes, nearest, cams: Camera, key: torch.Tensor):
        b = cams.center.shape[0]
        if b % n_cam:
            raise ValueError(f"{b} cameras do not split into {n_cam} groups")
        b_local = b // n_cam
        frames, total = [], None
        for ci in range(n_cam):
            row = []
            for ti in range(n_tile):
                dev = devs[ci * n_tile + ti]
                ys = ti * rows_local + torch.arange(rows_local, dtype=torch.int32, device=dev)
                xs = torch.arange(w, dtype=torch.int32, device=dev)
                pix = torch.stack([xs.expand(rows_local, w), ys[:, None].expand(rows_local, w)],
                                  dim=-1).reshape(-1, 2)
                out = []
                for i in range(b_local):
                    cam = Camera(*(x[ci * b_local + i].to(dev) for x in cams))
                    k = prng.fold_in(prng.fold_in(key.to(dev), ci * 65536 + i), ti)
                    cols = render_pixels(scenes[ci * n_tile + ti], cam, pix, k, cfg,
                                         nearest[ci * n_tile + ti])
                    out.append(cols.reshape(rows_local, w, 3))
                tile = torch.stack(out)
                part = tile.sum().to(devs[0], non_blocking=True)
                total = part if total is None else total + part
                row.append(tile)
            frames.append(row)
        return frames, total / (b * h * w * 3)

    def render(scene: DeviceScene, cams: Camera, key: torch.Tensor):
        scenes = scenes_of(scene)
        return render_tiles(scenes, backends(scenes), cams, key)

    return render


def gather_frames(frames) -> np.ndarray:
    """The renderer's frames assembled on the host: [B, H, W, 3]."""
    return np.concatenate(
        [np.concatenate([t.cpu().numpy() for t in row], axis=1) for row in frames], axis=0)


# --- The row-band interactive engine ------------------------------------------


class ShardedEngineState(NamedTuple):
    """The engine state over n row bands: every field is a tuple of n
    tensors, band i's on device i. The camera fields and the frame counter
    are replicated (every band computes the same values); the screen
    [C / n, cw*cw*3], the chunk queue [C / n] of band-local chunk ids, the
    cursor [] and the key [2] are each band's own."""

    cam_center: tuple
    quat: tuple
    half_theta: tuple
    screen: tuple
    perm: tuple
    cursor: tuple
    key: tuple
    frame: tuple

    @property
    def n_bands(self) -> int:
        return len(self.screen)

    def band(self, i: int) -> EngineState:
        return EngineState(*(f[i] for f in self))

    @staticmethod
    def from_bands(bands: Sequence[EngineState]) -> "ShardedEngineState":
        return ShardedEngineState(*(tuple(xs) for xs in zip(*bands)))


def _band_screen_cfg(cfg: EngineConfig, n_tile: int) -> ScreenConfig:
    """One band's ScreenConfig, used ONLY for the band-local chunk grid; rays
    are always made against the whole screen's config."""
    s = cfg.screen
    if s.height % n_tile:
        raise ValueError(f"{s.height} rows do not split into {n_tile} bands")
    rows = s.height // n_tile
    if rows % s.chunk_width:
        raise ValueError(f"bands of {rows} rows do not hold whole chunks of "
                         f"{s.chunk_width} pixels")
    return dataclasses.replace(
        s, height=rows, chunks_per_frame=max(1, s.effective_chunks_per_frame // n_tile))


def _exchange_halo_rows(screens: Sequence[torch.Tensor], band: ScreenConfig):
    """The halo rows of every band's chunk-major screen [C, cw*cw*3]:
    (halo_top, halo_bot), two lists of pixel rows [Cx, cw, 3] (= [width * 3]),
    each on its band's device. Band i's top halo is band i-1's last pixel row
    and its bottom halo band i+1's first; the outermost bands get their own
    edge row, which is the single screen's clamp."""
    cw, last = band.chunk_width, band.chunk_width - 1
    views = [s.reshape(band.chunks_y, band.chunks_x, cw, cw, 3) for s in screens]
    first_row = [t[0, :, :, 0, :].contiguous() for t in views]
    last_row = [t[-1, :, :, last, :].contiguous() for t in views]
    n = len(screens)
    halo_top = [first_row[0]] + [last_row[i - 1].to(screens[i].device, non_blocking=True)
                                 for i in range(1, n)]
    halo_bot = [first_row[i + 1].to(screens[i].device, non_blocking=True)
                for i in range(n - 1)] + [last_row[-1]]
    return halo_top, halo_bot


def _blur_with_halo_cm(cm: torch.Tensor, band: ScreenConfig, halo_top, halo_bot):
    """The plain cross blur of one band with its halo rows."""
    return feedback_blur_cm(cm, band, halo_top, halo_bot)


def _present_with_halo(cm: torch.Tensor, band: ScreenConfig, quantize: bool,
                       halo_top, halo_bot) -> torch.Tensor:
    """The present kernel's halo variant on one band (the plain version on
    a CPU band): blur + quantize in one read and one write."""
    return present(cm, band, quantize, halo_top=halo_top, halo_bot=halo_bot)


def _lazy_backends(cfg: EngineConfig, max_depth: int | None, max_leaf: int | None):
    """scenes -> the nearest-hit backend of each per-device copy (None for
    the fused kernel): the reference's ``_make_lazy_bounds_step``. The bvh
    traversal bounds come from the CONCRETE scene at its first use
    (render/pipeline.py scene_nearest_fn; None bounds are derived), and
    the backends are made once and kept for the latest scene only, so a
    long-lived engine pins no dead scene."""
    slot: list = []     # [(scenes, backends)]

    def get(scenes):
        if not (slot and slot[0][0] is scenes):
            slot[:] = [(scenes, [scene_nearest_fn(sc, cfg, max_depth, max_leaf)
                                 for sc in scenes])]
        return slot[0][1]

    return get


def _engine_locals(cfg: EngineConfig, devices, max_depth=None, max_leaf=None):
    """(band ScreenConfig, init_fn, local_step, scenes_of) shared by the
    per-frame and the scan engine: ``init_fn(seed=0)`` makes the band state,
    ``local_step(scenes, state, inputs)`` one frame of every band, and
    ``scenes_of(scene)`` the scene's copies on the device list."""
    devs = check_devices(devices)
    n_tile = len(devs)
    band = _band_screen_cfg(cfg, n_tile)
    n_chunks = band.effective_chunks_per_frame

    def local_init(seed: int, ti: int) -> EngineState:
        dev = devs[ti]
        key = prng.fold_in(prng.PRNGKey(seed, device=dev), ti)
        pkey, key = prng.split(key)
        cam = make_camera(cfg.camera, cfg.screen.width / cfg.screen.height, dev)
        return EngineState(
            cam_center=cam.center,
            quat=cam.rotation,
            half_theta=quat_ops.half_theta_of(cam.rotation),
            screen=torch.zeros((band.total_chunks, band.pixels_per_chunk * 3),
                               dtype=torch.float32, device=dev),
            perm=prng.permutation(pkey, band.total_chunks).to(torch.int32),
            cursor=torch.tensor(0, dtype=torch.int32, device=dev),
            key=key,
            frame=torch.tensor(0, dtype=torch.int32, device=dev),
        )

    backends = _lazy_backends(cfg, max_depth, max_leaf)

    def local_step(scenes, state: ShardedEngineState, inputs: FrameInputs):
        nearest = backends(scenes)
        # 1-4 per band: the band-local window (Morton-sorted and adaptively
        # reordered on the band's grid), the replicated camera, rays against
        # the whole screen at the band's row offset, the band-local scatter.
        bands = [advance_to_scatter(scenes[ti], cfg, n_chunks, state.band(ti), inputs,
                                    grid=band, row0=ti * band.height, nearest_fn=nearest[ti])
                 for ti in range(n_tile)]
        # 5. Present with the neighbours' rows, all read before any present.
        halo_top, halo_bot = _exchange_halo_rows([b.screen for b in bands], band)
        done = []
        for ti, b in enumerate(bands):
            screen = present_stage(
                b.screen, band,
                lambda scr, quantize, ti=ti: _present_with_halo(
                    scr, band, quantize, halo_top[ti], halo_bot[ti]),
                lambda scr, ti=ti: _blur_with_halo_cm(scr, band, halo_top[ti], halo_bot[ti]),
            )
            done.append(b._replace(screen=screen))
        return ShardedEngineState.from_bands(done)

    def init_fn(seed: int = 0) -> ShardedEngineState:
        return ShardedEngineState.from_bands([local_init(seed, ti) for ti in range(n_tile)])

    return band, init_fn, local_step, _scene_cache(devs)


def band_frames(state: ShardedEngineState, band: ScreenConfig) -> list:
    """Each band's uint8 display rows [H / n, W, 3], on its device."""
    return [to_display(cm_to_spatial(s, band)) for s in state.screen]


def assemble_frame(frames: Sequence[torch.Tensor]) -> torch.Tensor:
    """The bands' display rows stacked into the frame [H, W, 3] on the first
    band's device."""
    dev = frames[0].device
    return torch.cat([f.to(dev, non_blocking=True) for f in frames])


def _scene_cache(devs):
    """scene -> its copies on the device list; only the latest scene is
    kept, so a long-lived engine pins no dead scene's tensors."""
    slot: list = []

    def get(scene):
        if not (slot and slot[0][0] is scene):
            copies = (replicate_scene(scene, devs) if isinstance(scene, DeviceScene)
                      else list(scene))         # the per-device copies themselves
            slot[:] = [(scene, copies)]
        return slot[0][1]

    return get


def make_sharded_engine(cfg: EngineConfig, devices=None, max_depth: int | None = None,
                        max_leaf: int | None = None):
    """(init_fn, step_fn) of the row-band engine on the device list.

    ``init_fn(seed=0) -> ShardedEngineState``; ``step_fn(scene, state,
    FrameInputs) -> (state, frame [H, W, 3] uint8 on the first band's
    device)``. ``scene`` is a DeviceScene (copied to the other devices at its
    first use) or the list of its per-device copies. The camera behaves as the
    single engine's (runtime/step.py), every band refreshes its own rows from
    its own queue, and the blur crosses the band seams. The bvh traversal
    bounds default to the scene's (derived at the first call)."""
    band, init_fn, local_step, scenes_of = _engine_locals(cfg, devices, max_depth, max_leaf)

    def step_fn(scene, state: ShardedEngineState, inputs: FrameInputs):
        state = local_step(scenes_of(scene), state, inputs)
        return state, assemble_frame(band_frames(state, band))

    return init_fn, step_fn


def make_sharded_scan_engine(cfg: EngineConfig, devices=None, max_depth: int | None = None,
                             max_leaf: int | None = None):
    """(init_fn, scan_fn): many frames per call, ``scan_fn(scene, state,
    inputs) -> (state, last frame)`` with ``inputs`` a list of FrameInputs or
    a stacked one (runtime/step.py ``stack_inputs``). A plain loop of band
    steps, as runtime/step.py make_scan_step; only the final frame's display
    is built."""
    band, init_fn, local_step, scenes_of = _engine_locals(cfg, devices, max_depth, max_leaf)

    def scan_fn(scene, state: ShardedEngineState, inputs):
        scenes = scenes_of(scene)
        for inp in frame_inputs(inputs):
            state = local_step(scenes, state, inp)
        return state, assemble_frame(band_frames(state, band))

    return init_fn, scan_fn


# --- Between the band layout and the single engine's ---------------------------
#
# Bands stack in y and chunk-major order is row-major over (cy, cx), so band
# t's chunk id is the whole screen's id minus t * C_band, and the bands'
# screens concatenated ARE the single screen.


def sharded_to_single(state: ShardedEngineState, cfg: EngineConfig) -> EngineState:
    """The band state as a single engine's, on band 0's device. Exact: camera,
    yaw, frame counter and screen. The bands' queues are each rotated to
    cursor 0 (which keeps the pop order) and interleaved position by
    position, so the single engine's next windows refresh the union of what
    the bands would have; the key is band 0's."""
    dev = state.screen[0].device
    n_tile = state.n_bands
    c_band = cfg.screen.total_chunks // n_tile
    perm = np.stack([p.cpu().numpy() for p in state.perm])
    cursor = [int(c) for c in state.cursor]
    rolled = np.stack([np.roll(perm[t], -cursor[t]) for t in range(n_tile)])
    globalized = rolled + (np.arange(n_tile, dtype=rolled.dtype) * c_band)[:, None]
    interleaved = globalized.T.reshape(-1)          # position-major: b0[0], b1[0], ...
    return EngineState(
        cam_center=state.cam_center[0], quat=state.quat[0], half_theta=state.half_theta[0],
        screen=torch.cat([s.to(dev) for s in state.screen]),
        perm=torch.from_numpy(interleaved.astype(np.int32)).to(dev),
        cursor=torch.tensor(0, dtype=torch.int32, device=dev),
        key=state.key[0], frame=state.frame[0],
    )


def single_to_sharded(state: EngineState, cfg: EngineConfig, devices) -> ShardedEngineState:
    """A single engine's state as the bands of the device list. Exact fields
    as in ``sharded_to_single``. The queue is rotated to cursor 0 and
    filtered per band, order kept; band t's key is ``fold_in(key, t)``."""
    devs = check_devices(devices)
    n_tile = len(devs)
    c_band = cfg.screen.total_chunks // n_tile
    if c_band * n_tile != cfg.screen.total_chunks:
        raise ValueError(f"{cfg.screen.total_chunks} chunks do not split into {n_tile} bands")
    perm = np.roll(state.perm.cpu().numpy(), -int(state.cursor))
    bands = []
    for t, dev in enumerate(devs):
        own = perm[(perm // c_band) == t] - t * c_band
        bands.append(EngineState(
            cam_center=state.cam_center.to(dev), quat=state.quat.to(dev),
            half_theta=state.half_theta.to(dev),
            screen=state.screen[t * c_band:(t + 1) * c_band].to(dev),
            perm=torch.from_numpy(own.astype(np.int32)).to(dev),
            cursor=torch.tensor(0, dtype=torch.int32, device=dev),
            key=prng.fold_in(state.key.to(dev), t), frame=state.frame.to(dev),
        ))
    return ShardedEngineState.from_bands(bands)


def load_sharded_state(path: str, cfg: EngineConfig, devices=None) -> ShardedEngineState:
    """Restore any ``save_state`` checkpoint (either package's) as bands on
    the device list (None = one band on the CUDA card). A band checkpoint
    with as many bands restores bit for bit; a single engine's, or one with
    another band count, converts through the single layout
    (``sharded_to_single`` / ``single_to_sharded``)."""
    devs = check_devices(devices)
    arrays = read_checkpoint(path)
    if arrays["cursor"].ndim == 1:
        if arrays["cursor"].shape[0] == len(devs):
            _validate_band_shapes(arrays, cfg, len(devs), path)
            return from_reference_sharded_state(arrays, devs)
        saved = from_reference_sharded_state(arrays, ["cpu"] * arrays["cursor"].shape[0])
        check_checkpoint_shapes(path, arrays["screen"].shape, arrays["perm"].shape, cfg)
        single = sharded_to_single(saved, cfg)
    else:
        single = load_state(path, cfg, device="cpu")
    return single_to_sharded(single, cfg, devs)


def _validate_band_shapes(arrays: dict, cfg: EngineConfig, n_tile: int, path: str) -> None:
    """A band checkpoint's screen, queue and keys against the config and
    the band count."""
    want = (cfg.screen.total_chunks, cfg.screen.pixels_per_chunk * 3)
    if arrays["screen"].shape != want:
        raise ValueError(
            f"checkpoint {path!r} screen shape {arrays['screen'].shape} does not match this "
            f"config's chunk-major {want}; resume with the resolution/chunking it was "
            "saved under")
    if arrays["perm"].shape != (cfg.screen.total_chunks,):
        raise ValueError(f"checkpoint {path!r} chunk queue {arrays['perm'].shape} does not "
                         f"match this config's {(cfg.screen.total_chunks,)}")
    if arrays["key"].shape != (n_tile, 2):
        raise ValueError(f"checkpoint {path!r} key shape {arrays['key'].shape} does not "
                         f"match {(n_tile, 2)}")
