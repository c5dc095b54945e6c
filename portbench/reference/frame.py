"""A frame's glue in plain torch, for any subset of the frame's chunks: the
camera's rays with their jitter, the resolve of the traced light into the
screen (tone map, the mean of each pixel's samples), and the present (the
cross blur, 8-bit quantization). Written from the engine's description
(README, the reference app's shaders) in the precision ``dtype``; float32 is
what the configurations state.

Screens here are spatial, [H, W, 3]. A chunk of side cw at (cx, cy) of the
chunk grid holds the pixels (cx*cw + i // cw, cy*cw + i % cw), i < cw*cw (the
x offset slow); ray (pixel p of the window, sample s) is ray p*spp + s of the
frame's wavefront.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng

RUN = 32            # samples summed left to right into a run
BLOCK_RUNS = 32     # runs summed into a block


def rcp(x: float) -> float:
    """The float32 reciprocal of x, correctly rounded."""
    return float(np.float32(1.0) / np.float32(x))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)


def dot(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(a):
    return a / sqrt(dot(a, a))[..., None]


def hamilton(q1, q2):
    v1, w1 = q1[..., :3], q1[..., 3]
    v2, w2 = q2[..., :3], q2[..., 3]
    s = w1 * w2 - dot(v1, v2)
    v = cross(v1, v2) + w1[..., None] * v2 + w2[..., None] * v1
    return torch.cat([v, s[..., None]], dim=-1)


def rotate(vec, q):
    """(q^-1 * v * q).xyz with the Hamilton product."""
    conj = torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)
    v4 = torch.cat([vec, torch.zeros_like(vec[..., :1])], dim=-1)
    return hamilton(hamilton(conj, v4), q)[..., :3]


def chunk_pixels(cx: torch.Tensor, cy: torch.Tensor, cw: int) -> torch.Tensor:
    """The pixels [n * cw * cw, 2] (x, y) of chunks (cx, cy), in order."""
    i = torch.arange(cw * cw, device=cx.device)
    x = cx[:, None] * cw + i // cw
    y = cy[:, None] * cw + i % cw
    return torch.stack([x, y], dim=-1).reshape(-1, 2)


def rays(cfg: dict, center, quat, pixels: torch.Tensor, pixel_index: torch.Tensor,
         jkey: tuple, dtype):
    """(ori, dirs, ray ids) of the spp samples of ``pixels`` [K, 2], whose
    places in the frame's window are ``pixel_index`` [K]; ``center`` and
    ``quat`` are the camera's, as ``dtype`` tensors."""
    sc, cam = cfg["screen"], cfg["camera"]
    spp = sc["samples_per_pixel"]
    vh = cam["viewport_height"]
    vw = torch.tensor(vh * (sc["width"] / sc["height"]), dtype=torch.float32).to(dtype)
    vh = torch.tensor(vh, dtype=torch.float32).to(dtype)
    p = pixels.to(dtype)
    x = p[:, 0] * rcp(sc["width"]) * vw - vw / 2.0
    y = p[:, 1] * rcp(sc["height"]) * vh - vh / 2.0
    z = torch.full_like(x, float(np.float32(cam["focal_length"])))
    base = rotate(normalize(torch.stack([x, y, z], dim=-1)), quat.expand(x.shape[0], 4))
    ids = (pixel_index.to(torch.int64)[:, None] * spp
           + torch.arange(spp, device=pixels.device)).reshape(-1)
    u = prng.uniform(jkey, torch.stack([2 * ids, 2 * ids + 1], dim=-1), -1.0, 1.0, dtype)
    jit = torch.cat([u, torch.zeros_like(u[:, :1])], dim=-1) * float(np.float32(
        cfg["tracer"]["jitter"]))
    dirs = (base[:, None, :] + jit.reshape(-1, spp, 3)).reshape(-1, 3)
    ori = center.expand(dirs.shape[0], 3)
    return ori, dirs, ids


def resolve(light: torch.Tensor, spp: int, dtype) -> torch.Tensor:
    """The colours [K, 3] of light [K * spp, 3]: each sample's sqrt(max(l,
    0)), then the mean over a pixel's samples summed in runs of 32 left to
    right, runs into blocks of 32, blocks left to right, times 1/spp."""
    s = sqrt(torch.clamp_min(light.to(dtype), 0.0)).reshape(-1, spp, 3)
    total = None
    for b0 in range(0, spp, RUN * BLOCK_RUNS):
        block = None
        for r0 in range(b0, min(b0 + RUN * BLOCK_RUNS, spp), RUN):
            run = s[:, r0]
            for i in range(r0 + 1, min(r0 + RUN, spp)):
                run = run + s[:, i]
            block = run if block is None else block + run
        total = block if total is None else total + block
    return total * rcp(spp)


RCP3 = rcp(3.0)
RCP255 = rcp(255.0)


def present(screen: torch.Tensor) -> torch.Tensor:
    """The feedback blur (c + (l + r)/2 + (u + d)/2) * f32(1/3) with the
    edges clamped, then RGBA8 quantization: round(clamp(x, 0, 1) * 255)
    * f32(1/255), half to even."""
    p = torch.nn.functional.pad(screen.permute(2, 0, 1)[None].float(), (1, 1, 1, 1),
                                mode="replicate")[0].permute(1, 2, 0).to(screen.dtype)
    c, left, right = p[1:-1, 1:-1], p[1:-1, :-2], p[1:-1, 2:]
    u, d = p[:-2, 1:-1], p[2:, 1:-1]
    out = (c + (left + right) * 0.5 + (u + d) * 0.5) * RCP3
    return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0) * RCP255


def to_display(screen: torch.Tensor) -> torch.Tensor:
    """uint8 display values of a screen."""
    return torch.round(torch.clamp(screen.float(), 0.0, 1.0) * 255.0).to(torch.uint8)
