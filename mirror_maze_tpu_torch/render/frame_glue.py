"""The step's glue around the tracer: a frame's camera rays and the resolve
of its light into the screen, each one launch of a hand-written CUDA kernel
on the card (``csrc/camera_rays.cu``, ``csrc/resolve.cu``), where the JAX
package's ``jit`` fuses the same ops (render/pipeline.py, the ``[K, spp]``
sample layout). The frame's setup, the third glue kernel, is
runtime/step.py ``frame_setup``.

- ``pinhole_rays``: the pinhole camera's rays of K pixels x spp samples:
  pixel, direction (render/camera.py ``ray_directions``), jitter
  (ops/sampling.py ``ray_jitter``), origin, and under ``noise_rng`` the seed
  row. The pixels are a chunk ``Window`` of the screen (the engine) or a
  list [K, 2] (the offline render).
- ``resolve``: the tone map of each sample, their mean (``sample_mean``) and
  the chunk rows of the screen (render/accumulate.py ``scatter_chunk_rows``),
  or the colours [K, 3] where there is no screen.

Each dispatches on the device of its tensors: a CUDA tensor launches the
kernel (raising where it cannot), a CPU tensor runs the plain version, the
torch ops the kernel replaces, and any other device raises. The kernels are
bitwise their plain versions on the card. Two places of the plain versions
fix an order that torch leaves open: the divisions by the screen's size are
multiplies by float32 reciprocals (what torch does on the card and XLA under
``jit``; the CPU divides), and the mean sums in runs of 32 samples and
blocks of 32 runs (``sample_mean``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import EngineConfig, ScreenConfig
from ..device import constant, on_card
from ..ops.sampling import ray_jitter
from ..ops.vecmath import reciprocal
from ..utils.noise import sample_noise
from .accumulate import scatter_chunk_rows
from .camera import Camera, ray_directions
from .scheduler import chunk_origin_xy, chunk_pixels
from .tracer import tone_map

# Samples summed left to right before their run's sum is added to its block,
# and runs a block: XLA-CPU's jitted jnp.mean over the sample axis sums so
# (runs left to right into blocks of 1,024 samples, the blocks left to right)
# for spp <= 32, for multiples of 32 up to 1,024 and for multiples of 1,024.
RUN = 32
BLOCK_RUNS = 32
# The most samples a pixel the resolve kernel stages whole: csrc/resolve.cu
# stages a block's light, tone-mapped, in at most 48 KiB of shared memory
# (SMEM_BYTES), with 4 words of padding after every run's 96 floats, and the
# runs' sums beside it: a pixel of spp samples takes 3 * spp + 7 *
# ceil(spp / 32) words, which one pixel fills at 3816. Past it the kernel
# stages a pixel 32 runs at a time (resolve_pieces_kernel), in the same order.
RESOLVE_MAX_SPP = 3816


class Window(NamedTuple):
    """A frame's chunk window as its rays read it: the chunk ids [n] int32
    of ``grid``, whose first pixel row is ``row0`` of the whole screen (a
    band of the row-band engine; 0 for the single screen)."""
    ids: torch.Tensor
    grid: ScreenConfig
    row0: int = 0


def window_pixels(window: Window) -> torch.Tensor:
    """The window's pixels [n * cw * cw, 2] (x, y) int32 in chunk_pixels
    order."""
    origins = chunk_origin_xy(window.ids, window.grid)
    if window.row0:
        origins = origins + constant((0, window.row0), torch.int32, origins.device)
    return chunk_pixels(origins, window.grid.chunk_width)


def operand(kernel: str, name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
            device) -> int:
    """x's data pointer, after checking that it is a contiguous ``dtype``
    tensor of ``shape`` on ``device``."""
    if (x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device
            or not x.is_contiguous()):
        raise ValueError(f"the {kernel} kernel takes {name} as contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.data_ptr()


def params_type(pointers: tuple, ints: tuple, floats: tuple) -> type:
    """A ctypes Structure laid out as a kernel's ``Params``: the pointers,
    then the ints, then the floats, each in the order given."""
    return type("Params", (ctypes.Structure,), {"_fields_": (
        [(f, ctypes.c_void_p) for f in pointers] + [(f, ctypes.c_int) for f in ints]
        + [(f, ctypes.c_float) for f in floats])})


def need_card(dev: torch.device, kernel: str) -> None:
    """Raise unless ``dev`` is a CUDA device: a kernel wrapper never runs
    its plain version."""
    if dev.type != "cuda":
        raise ValueError(f"the {kernel} kernel runs on CUDA tensors, got {dev}; "
                         f"{kernel}_plain is the plain version")


# --- Camera rays ------------------------------------------------------------

_RaysParams = params_type(
    ("ids", "pixels", "center", "quat", "focal", "viewport", "jkey", "noise", "ori", "dirs",
     "seed_row"),
    ("n_rays", "spp", "chunks_x", "chunk_width", "row0", "noise_w", "noise_h", "spp_log2"),
    ("rcp_w", "rcp_h", "jitter"))


def _pixel_count(pixels) -> int:
    if isinstance(pixels, Window):
        return pixels.ids.shape[0] * pixels.grid.pixels_per_chunk
    return pixels.shape[0]


def pinhole_rays_plain(cam: Camera, pixels, jkey: torch.Tensor, cfg: EngineConfig,
                       noise: torch.Tensor | None = None) -> tuple:
    """The plain version of ``pinhole_rays``."""
    spp = cfg.screen.samples_per_pixel
    pix = window_pixels(pixels) if isinstance(pixels, Window) else pixels
    k = pix.shape[0]
    base = ray_directions(cam, pix, float(cfg.screen.width), float(cfg.screen.height))  # [K, 3]
    jit = ray_jitter(jkey, (k, spp), cfg.tracer.jitter)                          # [K, spp, 3]
    dirs = (base[:, None, :] + jit).reshape(k * spp, 3)
    ori = cam.center.expand(k * spp, 3).contiguous()
    seed_row = None
    if cfg.tracer.noise_rng:
        seed_row = torch.repeat_interleave(sample_noise(noise, pix), spp)
    return ori, dirs, seed_row


def pinhole_rays_kernel(cam: Camera, pixels, jkey: torch.Tensor, cfg: EngineConfig,
                        noise: torch.Tensor | None = None) -> tuple:
    """``pinhole_rays`` in one launch of the ``camera_rays`` kernel: bitwise
    its plain version. Raises on tensors that are not on a CUDA device and
    on malformed operands; there is no fallback."""
    dev = jkey.device
    need_card(dev, "camera_rays")
    spp = cfg.screen.samples_per_pixel
    k = _pixel_count(pixels)
    n_rays = k * spp
    if 2 * n_rays > 0xFFFFFFFF:
        raise ValueError(f"{n_rays} rays draw more than 2^32 - 1 jitter words")
    f32, i32 = torch.float32, torch.int32
    p = _RaysParams()
    if isinstance(pixels, Window):
        grid = pixels.grid
        p.ids = operand("camera_rays", "ids", pixels.ids, i32, (pixels.ids.shape[0],), dev)
        p.chunks_x, p.chunk_width, p.row0 = grid.chunks_x, grid.chunk_width, pixels.row0
    else:
        pixels = pixels.to(i32).contiguous()    # held until the launch
        p.pixels = operand("camera_rays", "pixels", pixels, i32, (k, 2), dev)
    p.center = operand("camera_rays", "center", cam.center, f32, (3,), dev)
    p.quat = operand("camera_rays", "rotation", cam.rotation, f32, (4,), dev)
    p.focal = operand("camera_rays", "focal", cam.focal, f32, (), dev)
    p.viewport = operand("camera_rays", "viewport", cam.viewport, f32, (2,), dev)
    p.jkey = operand("camera_rays", "jkey", jkey, torch.int64, (2,), dev)
    ori = torch.empty((n_rays, 3), dtype=f32, device=dev)
    dirs = torch.empty((n_rays, 3), dtype=f32, device=dev)
    p.ori, p.dirs = ori.data_ptr(), dirs.data_ptr()
    seed_row = None
    if cfg.tracer.noise_rng:
        p.noise_h, p.noise_w = noise.shape
        p.noise = operand("camera_rays", "noise", noise, f32, tuple(noise.shape), dev)
        seed_row = torch.empty(n_rays, dtype=f32, device=dev)
        p.seed_row = seed_row.data_ptr()
    p.n_rays, p.spp = n_rays, spp
    p.spp_log2 = spp.bit_length() - 1 if spp & (spp - 1) == 0 else -1
    p.rcp_w, p.rcp_h = reciprocal(cfg.screen.width), reciprocal(cfg.screen.height)
    p.jitter = float(np.float32(cfg.tracer.jitter))
    with torch.cuda.device(dev):            # the launch goes to this device's stream
        kernels.launch("camera_rays", ctypes.addressof(p))
    return ori, dirs, seed_row


def pinhole_rays(cam: Camera, pixels, jkey: torch.Tensor, cfg: EngineConfig,
                 noise: torch.Tensor | None = None) -> tuple:
    """The pinhole camera's rays of spp samples of each pixel: (ori [K*spp,
    3], dirs [K*spp, 3], seed row [K*spp] or None). ``pixels`` is a
    ``Window`` or a [K, 2] int32 (x, y) tensor; ``jkey`` the jitter's key
    (the frame key's first split). With ``cfg.tracer.noise_rng`` the seed
    row is the pixel's sample of ``noise``, shared by its samples
    (`shaders.metal:288-300`). Rays are made against ``cfg.screen`` whatever
    grid the window addresses."""
    if cfg.tracer.noise_rng and noise is None:
        raise ValueError("noise_rng needs the scene's noise texture")
    if on_card(jkey, "pinhole_rays"):
        return pinhole_rays_kernel(cam, pixels, jkey, cfg, noise)
    return pinhole_rays_plain(cam, pixels, jkey, cfg, noise)


# --- Resolve ----------------------------------------------------------------

_ResolveParams = params_type(("light", "ids", "out"), ("n_pixels", "spp", "ppc"), ("rcp_spp",))


def sample_mean(samples: torch.Tensor) -> torch.Tensor:
    """The mean of samples [K, spp, 3] over the samples in one fixed order:
    runs of RUN samples, each summed left to right; blocks of BLOCK_RUNS
    runs, each the runs' sums left to right; the blocks' sums left to right;
    times the float32 reciprocal of spp. It is XLA-CPU's jitted
    ``jnp.mean(samples, axis=1)`` for spp <= 32, for multiples of 32 up to
    1,024 and for multiples of 1,024 (XLA splits other large spp otherwise)."""
    spp = samples.shape[1]
    total = None
    for b0 in range(0, spp, RUN * BLOCK_RUNS):
        block = None
        for r0 in range(b0, min(b0 + RUN * BLOCK_RUNS, spp), RUN):
            run = samples[:, r0]
            for s in range(r0 + 1, min(r0 + RUN, spp)):
                run = run + samples[:, s]
            block = run if block is None else block + run
        total = block if total is None else total + block
    return total * reciprocal(spp)


def resolve_plain(light: torch.Tensor, spp: int, screen: torch.Tensor | None = None,
                  ids: torch.Tensor | None = None, in_place: bool = False) -> torch.Tensor:
    """The plain version of ``resolve``."""
    colors = sample_mean(tone_map(light).reshape(-1, spp, 3))
    if ids is None:
        return colors
    if in_place:
        return screen.index_copy_(0, ids.to(torch.int64), colors.reshape(ids.shape[0], -1))
    return scatter_chunk_rows(screen, ids, colors)


def resolve_kernel(light: torch.Tensor, spp: int, out: torch.Tensor,
                   ids: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the ``resolve`` kernel into ``out``: the rows ``ids``
    of the chunk-major screen ``out`` [C, cw*cw*3], or with no ids the
    colours ``out`` [K, 3], at any spp (past RESOLVE_MAX_SPP the pieces
    route). Bitwise ``resolve_plain``; raises off the card and on malformed
    operands."""
    dev = light.device
    need_card(dev, "resolve")
    f32 = torch.float32
    p = _ResolveParams()
    if ids is None:
        k, ppc = out.shape[0], 1
        p.out = operand("resolve", "out", out, f32, (k, 3), dev)
    else:
        if out.ndim != 2 or out.shape[1] % 3:
            raise ValueError(f"the resolve kernel writes screen rows [C, cw*cw*3], got "
                             f"{tuple(out.shape)}")
        ppc = out.shape[1] // 3
        k = ids.shape[0] * ppc
        p.ids = operand("resolve", "ids", ids, torch.int32, (ids.shape[0],), dev)
        p.out = operand("resolve", "screen", out, f32, tuple(out.shape), dev)
    if k * spp * 3 > 2 ** 31 - 1:
        # The tracer indexes a ray's light with an int (csrc/tracer.cu), so no
        # frame's light holds more.
        raise ValueError(f"the resolve kernel takes at most 2^31 - 1 light values, got {k} "
                         f"pixels of {spp} samples")
    p.light = operand("resolve", "light", light, f32, (k * spp, 3), dev)
    p.n_pixels, p.spp, p.ppc, p.rcp_spp = k, spp, ppc, reciprocal(spp)
    with torch.cuda.device(dev):
        kernels.launch("resolve", ctypes.addressof(p))
    return out


def resolve(light: torch.Tensor, spp: int, screen: torch.Tensor | None = None,
            ids: torch.Tensor | None = None, in_place: bool = False) -> torch.Tensor:
    """A frame's traced light [K*spp, 3] resolved: each sample's tone map,
    the mean of each pixel's spp samples (``sample_mean``), and with a
    chunk-major ``screen`` and the window's chunk ``ids`` the screen with
    those rows written (the pixels in chunk_pixels order), else the colours
    [K, 3]. The rows land in a copy of the screen, or with ``in_place`` in
    ``screen`` itself, which the caller must own: the step writes in place
    only into a graph runner's static buffers (runtime/graph.py)."""
    if not on_card(light, "resolve"):
        return resolve_plain(light, spp, screen, ids, in_place)
    if ids is None:
        out = torch.empty((light.shape[0] // spp, 3), dtype=torch.float32, device=light.device)
        return resolve_kernel(light, spp, out)
    return resolve_kernel(light, spp, screen if in_place else screen.clone(), ids)
