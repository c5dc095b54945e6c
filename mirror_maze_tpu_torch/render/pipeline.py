"""Frame rendering pipeline: pixels -> traced colors (counterpart of the JAX
package's ``render/pipeline.py``: the pinhole and thin-lens cameras, the
fused-tracer branch and the offline full-frame render).

Per sample, as the compute kernel (`shaders.metal:281-303`): one camera ray
per pixel, an unnormalized direction jitter of scale ``cfg.tracer.jitter``
per sample, then the per-sample tone map and a mean over the samples. With
``cfg.camera.aperture`` > 0 each sample's origin moves on a lens disk in the
camera plane and its direction is aimed again at the ray's point at
``focus_dist``, so what lies there stays sharp.
"""

from __future__ import annotations

import math

import torch

from ..config import EngineConfig
from ..ops import prng
from ..ops import quat as quat_ops
from ..ops.sampling import ray_jitter
from ..ops.vecmath import normalize
from ..utils.noise import sample_noise
from .camera import Camera, ray_directions
from .fused_tracer import trace_paths_fused
from .scenebuf import DeviceScene
from .tracer import tone_map

INT32_MAX = 2 ** 31 - 1


def frame_rays(
    cam: Camera,
    pixels_xy: torch.Tensor,   # [K, 2] int (x, y)
    key: torch.Tensor,
    cfg: EngineConfig,
    noise: torch.Tensor | None = None,   # the scene's noise texture (noise_rng)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The tracer's inputs for spp samples of each pixel: (ori [K*spp, 3],
    dirs [K*spp, 3], kernel seed int32 [1], seed row [K*spp] or None). With
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
        r = torch.sqrt(u[0]) * cfg.camera.aperture
        phi = (u[1] * (2.0 * math.pi)).double()
        off_cam = torch.stack([r * torch.cos(phi).float(), r * torch.sin(phi).float(),
                               torch.zeros_like(r)], dim=-1)
        off = quat_ops.rotate(off_cam, cam.rotation.expand(off_cam.shape[:-1] + (4,)))
        focus_p = ori + dirs * cfg.camera.focus_dist
        ori = ori + off
        # Normalized: t, and with it t_min, is measured in units of |d|.
        dirs = normalize(focus_p - ori)
    seed = prng.randint(tkey, (), 0, INT32_MAX).reshape(1)
    seed_row = None
    if cfg.tracer.noise_rng:
        if noise is None:
            raise ValueError("noise_rng needs the scene's noise texture")
        seed_row = torch.repeat_interleave(sample_noise(noise, pixels_xy), spp)
    return ori, dirs, seed, seed_row


def render_pixels(
    scene: DeviceScene,
    cam: Camera,
    pixels_xy: torch.Tensor,   # [K, 2] int (x, y)
    key: torch.Tensor,
    cfg: EngineConfig,
) -> torch.Tensor:
    """Trace spp samples for each pixel; returns tone-mapped colors [K, 3]."""
    if cfg.intersector != "pallas":
        raise NotImplementedError(
            f"intersector {cfg.intersector!r} is not ported yet; the port "
            "traces with the fused kernel (intersector='pallas')"
        )
    ori, dirs, seed, seed_row = frame_rays(cam, pixels_xy, key, cfg, scene.noise)
    light = trace_paths_fused(
        scene, ori, dirs, seed, cfg.tracer, rows_per_block=cfg.tracer.block_rows,
        anchor=cam.center, seed_row=seed_row,
    )
    spp = cfg.screen.samples_per_pixel
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
) -> torch.Tensor:
    """Offline full-frame render [H, W, 3] (float32, tone-mapped, not
    blurred), one block of pixel rows at a time, each with its own key."""
    w = cfg.screen.width
    return torch.cat([render_pixels(scene, cam, pix, bkey, cfg).reshape(-1, w, 3)
                      for pix, bkey in frame_row_batches(cfg, key, rows_per_batch,
                                                         cam.center.device)])
