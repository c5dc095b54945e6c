"""Frame rendering pipeline: pixels -> traced colors (counterpart of the JAX
package's ``render/pipeline.py``: the pinhole and thin-lens cameras, the
backend dispatch — the fused tracer kernel for ``intersector="pallas"``,
the jnp tracer of render/tracer.py with the brute, exact or bvh nearest-hit
backend otherwise — and the offline full-frame render).

Per sample, as the compute kernel (`shaders.metal:281-303`): one camera ray
per pixel, an unnormalized direction jitter of scale ``cfg.tracer.jitter``
per sample, then the per-sample tone map and a mean over the samples. With
``cfg.camera.aperture`` > 0 each sample's origin moves on a lens disk in the
camera plane and its direction is aimed again at the ray's point at
``focus_dist``, so what lies there stays sharp.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..config import EngineConfig
from ..ops import prng
from ..ops import quat as quat_ops
from ..ops.sampling import ray_jitter
from ..ops.vecmath import normalize, sqrt
from ..scene.bvh import traversal_bounds
from ..utils.noise import sample_noise
from .camera import Camera, ray_directions
from .fused_tracer import trace_paths_fused
from .intersect import (
    bvh_tables,
    nearest_hit_brute,
    nearest_hit_bvh,
    nearest_hit_bvh_kernel,
    nearest_hit_exact,
)
from .scenebuf import DeviceScene
from .tracer import tone_map, trace_paths

INT32_MAX = 2 ** 31 - 1


def camera_rays(
    cam: Camera,
    pixels_xy: torch.Tensor,   # [K, 2] int (x, y)
    key: torch.Tensor,
    cfg: EngineConfig,
    noise: torch.Tensor | None = None,   # the scene's noise texture (noise_rng)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The rays of spp samples of each pixel and the tracer's key: (ori
    [K*spp, 3], dirs [K*spp, 3], tkey [2], seed row [K*spp] or None). With
    ``cfg.tracer.noise_rng`` the seed row is the pixel's sample of ``noise``,
    shared by the pixel's samples (`shaders.metal:288-300`)."""
    spp = cfg.screen.samples_per_pixel
    k = pixels_xy.shape[0]
    jkey, tkey = prng.split(key)
    base_dir = ray_directions(
        cam, pixels_xy, float(cfg.screen.width), float(cfg.screen.height)
    )                                                        # [K, 3]
    jit = ray_jitter(jkey, (k, spp), cfg.tracer.jitter)      # [K, spp, 3]
    dirs = (base_dir[:, None, :] + jit).reshape(k * spp, 3)
    ori = cam.center.expand(k * spp, 3).contiguous()
    if cfg.camera.aperture > 0.0:
        # Thin lens: a uniform point of the lens disk (radius sqrt(u1) *
        # aperture, angle 2 pi u2) in the camera plane. sin and cos are
        # evaluated in float64 and rounded once, the same on every device.
        u = prng.uniform(prng.fold_in(jkey, 1), (2, k * spp))
        r = sqrt(u[0]) * cfg.camera.aperture
        phi = (u[1] * (2.0 * math.pi)).double()
        off_cam = torch.stack([r * torch.cos(phi).float(), r * torch.sin(phi).float(),
                               torch.zeros_like(r)], dim=-1)
        off = quat_ops.rotate(off_cam, cam.rotation.expand(off_cam.shape[:-1] + (4,)))
        focus_p = ori + dirs * cfg.camera.focus_dist
        ori = ori + off
        # Normalized: t, and with it t_min, is measured in units of |d|.
        dirs = normalize(focus_p - ori)
    seed_row = None
    if cfg.tracer.noise_rng:
        if noise is None:
            raise ValueError("noise_rng needs the scene's noise texture")
        seed_row = torch.repeat_interleave(sample_noise(noise, pixels_xy), spp)
    return ori, dirs, tkey, seed_row


def frame_rays(
    cam: Camera,
    pixels_xy: torch.Tensor,   # [K, 2] int (x, y)
    key: torch.Tensor,
    cfg: EngineConfig,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The fused tracer's inputs: ``camera_rays`` with the tracer key drawn
    into the kernel seed, (ori, dirs, seed int32 [1], seed row or None)."""
    ori, dirs, tkey, seed_row = camera_rays(cam, pixels_xy, key, cfg, noise)
    seed = prng.randint(tkey, (), 0, INT32_MAX).reshape(1)
    return ori, dirs, seed, seed_row


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


def render_pixels(
    scene: DeviceScene,
    cam: Camera,
    pixels_xy: torch.Tensor,   # [K, 2] int (x, y)
    key: torch.Tensor,
    cfg: EngineConfig,
    nearest_fn: Callable | None = None,
) -> torch.Tensor:
    """Trace spp samples for each pixel; returns tone-mapped colors [K, 3].

    ``intersector="pallas"`` with no ``nearest_fn`` launches the fused
    tracer kernel; otherwise the jnp tracer runs with ``nearest_fn``, or
    with the configured backend built here (the bvh bounds then come from
    the scene's BVH, a host fetch: callers that render many times pass a
    ``nearest_fn`` made once with ``make_nearest_fn``)."""
    spp = cfg.screen.samples_per_pixel
    if cfg.intersector == "pallas" and nearest_fn is None:
        ori, dirs, seed, seed_row = frame_rays(cam, pixels_xy, key, cfg, scene.noise)
        light = trace_paths_fused(
            scene, ori, dirs, seed, cfg.tracer, rows_per_block=cfg.tracer.block_rows,
            anchor=cam.center, seed_row=seed_row,
        )
    else:
        if nearest_fn is None:
            nearest_fn = scene_nearest_fn(scene, cfg)
        ori, dirs, tkey, seed_row = camera_rays(cam, pixels_xy, key, cfg, scene.noise)
        light = trace_paths(scene.prims, ori, dirs, tkey, cfg.tracer, nearest_fn,
                            seed_row=seed_row)
    return tone_map(light).reshape(-1, spp, 3).mean(dim=1)


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
