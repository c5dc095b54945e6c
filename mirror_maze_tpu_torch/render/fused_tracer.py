"""Fused path tracer (counterpart of the JAX package's
``render/pallas_tracer.py``).

``trace_paths_fused`` traces a ray wavefront through the whole bounce loop
and returns the gathered light [R, 3]. On CUDA tensors it launches the
hand-written kernel (csrc/tracer.cu, one thread per ray); on CPU tensors it
runs ``trace_paths_plain``, the same arithmetic in PyTorch, vectorized over
rays with [R, P] intermediates and a Python loop over segments.

Both reproduce the Pallas kernel as the CPU interpreter runs it, for the
slice the maze needs (opaque quads of test modes 0-2 in one tile, no sky,
no noise seed row):

- nearest hit: t = numer * (1/denom) with the plane constants dotted
  against (o, 1, d) left to right; the edge tests of the plane's mode,
  min(s, 1-s) >= 0; t > t_min; misses at BIG;
- planes tied exactly on the nearest t sum their properties (the
  reference's one-hot select);
- the PCG stream of ray i is seeded from (seed, i // B, i % B), B the
  reference's rays per Pallas program (``rows_per_block * 128``), so the
  image depends on B and never on the CUDA launch geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import TracerConfig

BIG = 1e30
LANES = 128
MASK = 0xFFFFFFFF
PLAIN_CHUNK = 1 << 16   # rays per pass of the plain version


def _f32(x: float) -> float:
    """x rounded to float32 (the value the reference computes with)."""
    return float(np.float32(x))


_SINPI = tuple(_f32(c) for c in (3.14159099, -5.16747237, 2.54484882, -0.56204532))


def _sinpi(t: torch.Tensor) -> torch.Tensor:
    """sin(pi*t) for t in [-0.5, 0.5]: the reference's odd polynomial."""
    c1, c2, c3, c4 = _SINPI
    t2 = t * t
    return t * (c1 + t2 * (c2 + t2 * (c3 + t2 * c4)))


def _pcg_scramble(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One PCG step on uint32 values held in int64: (new state, word)."""
    state = (state * 747796405 + 291336453) & MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK
    return state, (word >> 22) ^ word


def pcg_init(seed: torch.Tensor, n: int, block_rays: int) -> torch.Tensor:
    """Per-ray PCG state [n] (int64 holding uint32): seed + pid*2654435761
    + r*15823 with pid = i // B, r = i % B, then two scramble rounds."""
    i = torch.arange(n, dtype=torch.int64, device=seed.device)
    state = (seed.to(torch.int64).reshape(()) + (i // block_rays) * 2654435761
             + (i % block_rays) * 15823) & MASK
    for _ in range(2):
        _, state = _pcg_scramble(state)
    return state


def _nearest(planes, counts, o, d, t_min):
    """(t [R], sel [R, 10]) over all planes; sel = normal, albedo,
    emission, is_mirror of the winner (tie-summed), zeros on a miss."""
    n0, n1, _ = counts
    pn, pd = planes[:, 0:3], planes[:, 3]
    w1, b1 = planes[:, 4:7], planes[:, 7]
    w2, b2 = planes[:, 8:11], planes[:, 11]

    def dot3(v, w):  # [R, 3] x [P, 3] -> [R, P], x + y + z left to right
        return (v[:, 0:1] * w[:, 0] + v[:, 1:2] * w[:, 1]) + v[:, 2:3] * w[:, 2]

    numer = pd - dot3(o, pn)
    denom = dot3(d, pn)
    t = numer * (1.0 / denom)
    s1 = (dot3(o, w1) - b1) + t * dot3(d, w1)
    s2 = (dot3(o, w2) - b2) + t * dot3(d, w2)
    p = planes.shape[0]
    idx = torch.arange(p, device=planes.device)
    edge1 = ((s1 >= 0) & (1.0 - s1 >= 0)) | (idx >= n0 + n1)
    edge2 = ((s2 >= 0) & (1.0 - s2 >= 0)) | (idx >= n0)
    ok = (t > t_min) & edge1 & edge2
    tv = torch.where(ok, t, torch.full_like(t, BIG))
    tmin = tv.min(dim=1).values
    thresh = torch.where(tmin < BIG, tmin, torch.full_like(tmin, -1.0))
    onehot = (tv <= thresh[:, None]).to(torch.float32)
    props = torch.cat([planes[:, 0:3], planes[:, 12:19]], dim=1)   # [P, 10]
    return tmin, onehot @ props


def trace_paths_plain(
    planes: torch.Tensor,       # [P, 20] records (render/scenebuf.py)
    mode_counts: tuple,
    ori: torch.Tensor,          # [R, 3]
    dirs: torch.Tensor,         # [R, 3]
    seed: torch.Tensor,         # int32, one element
    cfg: TracerConfig,
    rows_per_block: int,
    stats: dict | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the fused tracer: light [R, 3].

    Runs PLAIN_CHUNK rays at a time to bound the [rays, planes]
    intermediates. With ``stats``, adds to ``stats["ray_segments"]`` the
    number of (ray, segment) pairs traced alive — the work the kernel does
    on these rays."""
    rng = pcg_init(seed, ori.shape[0], rows_per_block * LANES)
    parts = []
    for c0 in range(0, ori.shape[0], PLAIN_CHUNK):
        sl = slice(c0, c0 + PLAIN_CHUNK)
        parts.append(_trace_plain_chunk(planes, mode_counts, ori[sl], dirs[sl],
                                        rng[sl], cfg, stats))
    return torch.cat(parts) if parts else torch.zeros_like(ori)


def _trace_plain_chunk(planes, mode_counts, o, d, rng, cfg, stats):
    t_min = _f32(cfg.t_min)
    tint = _f32(cfg.mirror_tint)
    tp = torch.ones_like(o)                         # throughput rgb
    lt = torch.zeros_like(o)                        # gathered light rgb
    mh = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    dc = torch.zeros_like(mh)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for _ in range(cfg.max_segments):
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        if stats is not None:
            stats["ray_segments"] = stats.get("ray_segments", 0) + n_alive
        t, sel = _nearest(planes, mode_counts, o, d, t_min)
        n, c, e, mir = sel[:, 0:3], sel[:, 3:6], sel[:, 6:9], sel[:, 9]
        hit = alive & (t < BIG)
        dn = (d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1]) + d[:, 2] * n[:, 2]
        side = -torch.sign(dn)
        mirror = hit & (mir > 0.0) & (side != -1.0)
        diffuse = hit & ~mirror
        mh_new = mh + mirror.to(torch.int32)
        mirror_live = mirror & (mh_new < cfg.mirror_limit)

        rng, word = _pcg_scramble(rng)
        u1 = (word & 0xFFFF).to(torch.float32) * (1.0 / 65536.0)
        u2 = (word >> 16).to(torch.float32) * (1.0 / 65536.0)
        z = u1 * 2.0 - 1.0
        x = u2 * 2.0 - 1.0
        k = torch.round(x)
        sphi = _sinpi(x - k) * (1.0 - 2.0 * torch.abs(k))
        cphi = _sinpi(0.5 - torch.abs(x))
        r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        u = torch.stack([r * cphi, r * sphi, z], dim=1)

        dif = diffuse[:, None]
        lt = torch.where(dif, lt + e * tp, lt)
        tp = torch.where(dif, tp * c, tp)
        lt = torch.where(mirror_live[:, None], lt + c * tint, lt)
        v = torch.where(dif, u + n * side[:, None], d - 2.0 * dn[:, None] * n)
        v_inv = 1.0 / torch.sqrt((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2])
        o = o + d * t[:, None]
        d = v * v_inv[:, None]
        mh = mh_new
        dc = dc + diffuse.to(torch.int32)
        alive = hit & ~(mirror & (mh_new >= cfg.mirror_limit)) & (dc < cfg.bounce_limit)
    return lt


def trace_paths_fused(
    planes: torch.Tensor,       # [P, 20] records (render/scenebuf.py)
    mode_counts: tuple,
    ori: torch.Tensor,          # [R, 3] float32
    dirs: torch.Tensor,         # [R, 3] float32
    seed: torch.Tensor,         # int32, one element, on the rays' device
    cfg: TracerConfig,
    rows_per_block: int,
) -> torch.Tensor:
    """Trace a ray wavefront; returns light [R, 3]. The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    dev = ori.device
    for name, x, dtype in (("planes", planes, torch.float32),
                           ("ori", ori, torch.float32),
                           ("dirs", dirs, torch.float32),
                           ("seed", seed, torch.int32)):
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got {x.dtype} on {x.device}")
    if ori.ndim != 2 or ori.shape[1] != 3 or dirs.shape != ori.shape:
        raise ValueError(f"ori/dirs must both be [R, 3], got {tuple(ori.shape)}, {tuple(dirs.shape)}")
    if planes.ndim != 2 or planes.shape[1] != 20 or sum(mode_counts) != planes.shape[0]:
        raise ValueError("planes must be [P, 20] records with mode counts summing to P")
    if seed.numel() != 1:
        raise ValueError("seed must hold one int32")
    if dev.type == "cpu":
        return trace_paths_plain(planes, mode_counts, ori, dirs, seed, cfg, rows_per_block)
    if dev.type != "cuda":
        raise ValueError(f"trace_paths_fused runs on cuda or cpu tensors, got {dev}")
    ori, dirs, planes, seed = (x.contiguous() for x in (ori, dirs, planes, seed))
    light = torch.empty_like(ori)
    kernels.launch(
        "tracer", ori.data_ptr(), dirs.data_ptr(), planes.data_ptr(),
        planes.shape[0], mode_counts[0], mode_counts[1], seed.data_ptr(),
        light.data_ptr(), ori.shape[0], rows_per_block * LANES,
        cfg.max_segments, cfg.bounce_limit, cfg.mirror_limit,
        _f32(cfg.mirror_tint), _f32(cfg.t_min),
    )
    return light
