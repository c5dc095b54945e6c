"""Frame rendering pipeline: pixels -> traced colors (counterpart of the JAX
package's ``render/pipeline.py``: the pinhole camera and the fused-tracer
branch).

Per sample, as the compute kernel (`shaders.metal:281-303`): one camera ray
per pixel, an unnormalized direction jitter of scale ``cfg.tracer.jitter``
per sample, then the per-sample tone map and a mean over the samples.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..ops import prng
from ..ops.sampling import ray_jitter
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tracer's inputs for spp samples of each pixel: (ori [K*spp, 3],
    dirs [K*spp, 3], kernel seed int32 [1])."""
    if cfg.camera.aperture > 0.0 or cfg.tracer.noise_rng or cfg.tracer.sky_strength != 0.0:
        raise NotImplementedError(
            "depth of field, noise_rng and the sky term are not ported yet"
        )
    spp = cfg.screen.samples_per_pixel
    k = pixels_xy.shape[0]
    jkey, tkey = prng.split(key)
    base_dir = ray_directions(
        cam, pixels_xy, float(cfg.screen.width), float(cfg.screen.height)
    )                                                        # [K, 3]
    jit = ray_jitter(jkey, (k, spp), cfg.tracer.jitter)      # [K, spp, 3]
    dirs = (base_dir[:, None, :] + jit).reshape(k * spp, 3)
    ori = cam.center.expand(k * spp, 3).contiguous()
    seed = prng.randint(tkey, (), 0, INT32_MAX).reshape(1)
    return ori, dirs, seed


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
    ori, dirs, seed = frame_rays(cam, pixels_xy, key, cfg)
    light = trace_paths_fused(
        scene.planes, scene.mode_counts, ori, dirs, seed, cfg.tracer,
        rows_per_block=cfg.tracer.block_rows,
    )
    spp = cfg.screen.samples_per_pixel
    return tone_map(light).reshape(-1, spp, 3).mean(dim=1)
