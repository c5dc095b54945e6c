"""Frame rendering pipeline: pixels -> traced colors (counterpart of the JAX
package's ``render/pipeline.py``: the pinhole and thin-lens cameras, the
backend dispatch — the fused tracer kernel for ``intersector="pallas"``,
the jnp tracer of render/tracer.py with the brute, exact or bvh nearest-hit
backend otherwise — and the offline full-frame render).

Per sample, as the compute kernel (`shaders.metal:281-303`): one camera ray
per pixel, an unnormalized direction jitter of scale ``cfg.tracer.jitter``
per sample, then the per-sample tone map and a mean over the samples (on
the card the ``camera_rays`` and ``resolve`` kernels around the tracer,
render/frame_glue.py). With ``cfg.camera.aperture`` > 0 each sample's origin
moves on a lens disk in the camera plane and its direction is aimed again
at the ray's point at ``focus_dist``, so what lies there stays sharp.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..config import EngineConfig
from ..ops import prng
from ..ops import quat as quat_ops
from ..ops.vecmath import normalize, sqrt
from ..scene.bvh import traversal_bounds
from .camera import Camera
from .frame_glue import pinhole_rays, resolve
from .fused_tracer import trace_paths_fused
from .intersect import (
    bvh_tables,
    nearest_hit_brute,
    nearest_hit_bvh,
    nearest_hit_bvh_kernel,
    nearest_hit_exact,
)
from .scenebuf import DeviceScene
from .tracer import trace_paths

INT32_MAX = 2 ** 31 - 1


def thin_lens(cam: Camera, ori: torch.Tensor, dirs: torch.Tensor, jkey: torch.Tensor,
              cfg: EngineConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The thin lens (``cfg.camera.aperture`` > 0) on pinhole rays: each
    sample's origin moves to a uniform point of the lens disk (radius
    sqrt(u1) * aperture, angle 2 pi u2) in the camera plane and its
    direction aims again at its point at ``focus_dist``. sin and cos are
    evaluated in float64 and rounded once, the same on every device. Torch
    ops on every device (the lens has no kernel)."""
    n = ori.shape[0]
    u = prng.uniform(prng.fold_in(jkey, 1), (2, n))
    r = sqrt(u[0]) * cfg.camera.aperture
    phi = (u[1] * (2.0 * math.pi)).double()
    off_cam = torch.stack([r * torch.cos(phi).float(), r * torch.sin(phi).float(),
                           torch.zeros_like(r)], dim=-1)
    off = quat_ops.rotate(off_cam, cam.rotation.expand(off_cam.shape[:-1] + (4,)))
    focus_p = ori + dirs * cfg.camera.focus_dist
    ori = ori + off
    # Normalized: t, and with it t_min, is measured in units of |d|.
    return ori, normalize(focus_p - ori)


def sample_rays(cam: Camera, pixels, jkey: torch.Tensor, cfg: EngineConfig,
                noise: torch.Tensor | None = None) -> tuple:
    """The rays of spp samples of each pixel, (ori [K*spp, 3], dirs [K*spp,
    3], seed row [K*spp] or None): the pinhole's (render/frame_glue.py
    ``pinhole_rays``, the ``camera_rays`` kernel on the card), through the
    thin lens where ``cfg.camera.aperture`` > 0. ``pixels`` is a chunk
    ``Window`` or a [K, 2] int32 (x, y) tensor, ``jkey`` the jitter's key."""
    ori, dirs, seed_row = pinhole_rays(cam, pixels, jkey, cfg, noise)
    if cfg.camera.aperture > 0.0:
        ori, dirs = thin_lens(cam, ori, dirs, jkey, cfg)
    return ori, dirs, seed_row


def camera_rays(
    cam: Camera,
    pixels_xy: torch.Tensor,   # [K, 2] int32 (x, y)
    key: torch.Tensor,
    cfg: EngineConfig,
    noise: torch.Tensor | None = None,   # the scene's noise texture (noise_rng)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The rays of spp samples of each pixel and the tracer's key: (ori
    [K*spp, 3], dirs [K*spp, 3], tkey [2], seed row [K*spp] or None), the
    key split into the jitter's and the tracer's. With
    ``cfg.tracer.noise_rng`` the seed row is the pixel's sample of
    ``noise``, shared by the pixel's samples (`shaders.metal:288-300`)."""
    jkey, tkey = prng.split(key)
    ori, dirs, seed_row = sample_rays(cam, pixels_xy, jkey, cfg, noise)
    return ori, dirs, tkey, seed_row


def tracer_seed(tkey: torch.Tensor) -> torch.Tensor:
    """The fused tracer's seed int32 [1] drawn from the tracer's key."""
    return prng.randint(tkey, (), 0, INT32_MAX).reshape(1)


def frame_rays(
    cam: Camera,
    pixels_xy: torch.Tensor,   # [K, 2] int32 (x, y)
    key: torch.Tensor,
    cfg: EngineConfig,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The fused tracer's inputs: ``camera_rays`` with the tracer key drawn
    into the kernel seed, (ori, dirs, seed int32 [1], seed row or None)."""
    ori, dirs, tkey, seed_row = camera_rays(cam, pixels_xy, key, cfg, noise)
    return ori, dirs, tracer_seed(tkey), seed_row


def derive_traversal_bounds(scene: DeviceScene, cfg: EngineConfig, max_depth: int | None,
                            max_leaf: int | None) -> tuple[int, int]:
    """Fill None traversal bounds from the scene's BVH (scene/bvh.py
    traversal_bounds): a fixed max_leaf would drop primitives of large
    leaves, a fixed max_depth overflow the stack. Only the ``bvh``
    intersector walks the BVH, so only it fetches the arrays to the host;
    the others keep the defaults 32 and 4."""
    if max_depth is not None and max_leaf is not None:
        return max_depth, max_leaf
    if cfg.intersector != "bvh":
        return max_depth or 32, max_leaf or 4
    d, leaf = traversal_bounds(scene.prims.bvh_left_first.cpu().numpy(),
                               scene.prims.bvh_count.cpu().numpy())
    return (max_depth or d), (max_leaf or leaf)


def scene_nearest_fn(scene: DeviceScene, cfg: EngineConfig, max_depth: int | None = None,
                     max_leaf: int | None = None) -> Callable | None:
    """The backend of ``cfg.intersector`` for a scene, made once by the
    callers that trace it many times: None for the fused kernel
    (``pallas``), else ``make_nearest_fn`` with the bounds derived from the
    scene."""
    if cfg.intersector == "pallas":
        return None
    return make_nearest_fn(scene, cfg, *derive_traversal_bounds(scene, cfg, max_depth, max_leaf))


def make_nearest_fn(scene: DeviceScene, cfg: EngineConfig, max_depth: int,
                    max_leaf: int) -> Callable:
    """The nearest-hit backend of ``cfg.intersector`` over the scene's
    scene-order view: ``fn(o, d, live=None) -> (t, idx)``. For ``bvh`` the
    packed traversal tables are built here, once, and the walk is the
    ``bvh_walk`` kernel where the scene is on a CUDA device, which walks only
    the rays of ``live = (ids, count)`` when trace_paths passes that list;
    elsewhere it is the plain walk. The dense backends, and the plain walk,
    test every ray whatever ``live`` says (the rays not listed are never
    read)."""
    prims, t_min = scene.prims, cfg.tracer.t_min
    if cfg.intersector == "bvh":
        tables = bvh_tables(prims, max_leaf)
        if prims.normal.device.type == "cuda":
            return lambda o, d, live=None: nearest_hit_bvh_kernel(
                prims, o, d, t_min, max_depth, max_leaf, tables=tables, live=live)
        return lambda o, d, live=None: nearest_hit_bvh(prims, o, d, t_min, max_depth, max_leaf,
                                                       tables=tables)
    if cfg.intersector == "exact":
        return lambda o, d, live=None: nearest_hit_exact(prims, o, d, t_min)
    return lambda o, d, live=None: nearest_hit_brute(prims, o, d, t_min)


def fused(cfg: EngineConfig, nearest_fn: Callable | None) -> bool:
    """Whether a frame goes through the fused tracer kernel: ``pallas``
    with no jnp backend handed in."""
    return cfg.intersector == "pallas" and nearest_fn is None


def trace_samples(scene: DeviceScene, cam: Camera, pixels, jkey: torch.Tensor,
                  tkey: torch.Tensor | None, seed: torch.Tensor | None, cfg: EngineConfig,
                  nearest_fn: Callable | None = None) -> torch.Tensor:
    """The light [K*spp, 3] of spp samples of each pixel (a chunk ``Window``
    or [K, 2] int32 pixels): ``sample_rays`` with the jitter's key ``jkey``,
    then the fused tracer kernel with ``seed`` (``fused``), or the jnp tracer
    with the tracer's key ``tkey`` and ``nearest_fn`` (made here from the
    configured backend where None: for ``bvh`` a host fetch)."""
    ori, dirs, seed_row = sample_rays(cam, pixels, jkey, cfg, scene.noise)
    if fused(cfg, nearest_fn):
        return trace_paths_fused(scene, ori, dirs, seed, cfg.tracer,
                                 rows_per_block=cfg.tracer.block_rows, anchor=cam.center,
                                 seed_row=seed_row)
    if nearest_fn is None:
        nearest_fn = scene_nearest_fn(scene, cfg)
    return trace_paths(scene.prims, ori, dirs, tkey, cfg.tracer, nearest_fn, seed_row=seed_row)


def render_pixels(
    scene: DeviceScene,
    cam: Camera,
    pixels_xy: torch.Tensor,   # [K, 2] int32 (x, y)
    key: torch.Tensor,
    cfg: EngineConfig,
    nearest_fn: Callable | None = None,
) -> torch.Tensor:
    """Trace spp samples for each pixel; returns tone-mapped colors [K, 3].

    ``intersector="pallas"`` with no ``nearest_fn`` launches the fused
    tracer kernel; otherwise the jnp tracer runs with ``nearest_fn``, or
    with the configured backend built here (the bvh bounds then come from
    the scene's BVH, a host fetch: callers that render many times pass a
    ``nearest_fn`` made once with ``make_nearest_fn``). The colours are the
    samples' tone maps and mean (render/frame_glue.py ``resolve``)."""
    jkey, tkey = prng.split(key)
    seed = tracer_seed(tkey) if fused(cfg, nearest_fn) else None
    light = trace_samples(scene, cam, pixels_xy, jkey, tkey, seed, cfg, nearest_fn)
    return resolve(light, cfg.screen.samples_per_pixel)


def frame_row_batches(cfg: EngineConfig, key: torch.Tensor, rows_per_batch: int, device):
    """The offline render's work list: (pixels [rows * W, 2] int32, key) of
    each block of ``rows_per_batch`` pixel rows (cut to the largest divisor
    of the height not above it), top to bottom, each with its own key."""
    h, w = cfg.screen.height, cfg.screen.width
    while h % rows_per_batch != 0:
        rows_per_batch -= 1
    xs = torch.arange(w, dtype=torch.int32, device=device)
    keys = prng.split(key, h // rows_per_batch)
    for b in range(h // rows_per_batch):
        ys = torch.arange(b * rows_per_batch, (b + 1) * rows_per_batch,
                          dtype=torch.int32, device=device)
        pix = torch.stack([xs.expand(rows_per_batch, w),
                           ys[:, None].expand(rows_per_batch, w)], dim=-1).reshape(-1, 2)
        yield pix, keys[b]


def render_full_frame(
    scene: DeviceScene,
    cam: Camera,
    key: torch.Tensor,
    cfg: EngineConfig,
    rows_per_batch: int = 64,
    nearest_fn: Callable | None = None,
) -> torch.Tensor:
    """Offline full-frame render [H, W, 3] (float32, tone-mapped, not
    blurred), one block of pixel rows at a time, each with its own key.
    A jnp backend (``brute``, ``exact``, ``bvh``) is built once for the
    frame when ``nearest_fn`` is None."""
    if nearest_fn is None:
        nearest_fn = scene_nearest_fn(scene, cfg)
    w = cfg.screen.width
    return torch.cat([render_pixels(scene, cam, pix, bkey, cfg, nearest_fn).reshape(-1, w, 3)
                      for pix, bkey in frame_row_batches(cfg, key, rows_per_batch,
                                                         cam.center.device)])
