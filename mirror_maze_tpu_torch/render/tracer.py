"""The jnp path tracer and the per-sample tone map (counterpart of the JAX
package's ``render/tracer.py``).

``trace_paths`` is the reference's masked bounce loop: a fixed
``bounce_limit + mirror_limit`` segments over the whole ray front with a
liveness mask per ray, each segment one nearest-hit call of the selected
backend (render/intersect.py) and the shading of `shaders.metal:306-339`:

- the side of a hit is -sign(dot(dir, normal)); a diffuse surface, or the
  back face of a mirror, adds emission.rgb * emission.a * throughput,
  multiplies throughput by the albedo and scatters along normal * side plus
  a random unit vector;
- a mirror front face counts against ``mirror_limit``; under it the ray adds
  the flat tint albedo * ``mirror_tint`` and reflects, at it the ray dies;
- glass (ior > 0, only in a scene that has some) refracts by Snell, splits
  by Schlick's Fresnel term with ``fresnel`` on (else reflects on total
  internal reflection only), counts against the mirror budget and tints
  the throughput by the albedo;
- a checker texture swaps the albedo for its second colour on odd cells;
- a miss gathers sky_color * lighting_factor^(segment - mirror hits) *
  sky_strength (0 by default, as the reference).

Segment ``it`` draws its unit vectors from ``fold_in(key, it)`` and its
Fresnel uniforms from ``fold_in(fold_in(key, it), 1)``; with ``seed_row``
ray i draws from ``fold_in(fold_in(fold_in(key, i), int(seed_row[i] *
2^24)), it)`` instead, as the reference's ``vmap`` over rays does. The
draws are jax.random's (ops/prng.py), so the light follows the reference
ray for ray up to the rounding of the glue.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import TracerConfig
from ..device import constant
from ..ops import prng
from ..ops.sampling import unit_sphere
from ..ops.vecmath import dot, normalize, reflect, sqrt
from .intersect import BIG, nearest_hit_brute
from .scenebuf import ScenePrims

NearestFn = Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def _pow5(x: torch.Tensor) -> torch.Tensor:
    """x^5 as jax's integer_pow multiplies it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def trace_paths(
    prims: ScenePrims,
    ori: torch.Tensor,    # [R, 3]
    dirs: torch.Tensor,   # [R, 3]
    key: torch.Tensor,
    cfg: TracerConfig,
    nearest_fn: NearestFn | None = None,
    seed_row: torch.Tensor | None = None,   # [R] float32 in [0, 1)
) -> torch.Tensor:
    """Trace one wavefront of rays through the scene-order view ``prims``;
    returns the gathered light [R, 3]. ``nearest_fn(o, d) -> (t, idx)`` is
    the backend (``nearest_hit_brute`` when None)."""
    if nearest_fn is None:
        nearest_fn = lambda o, d: nearest_hit_brute(prims, o, d, cfg.t_min)
    n_rays = ori.shape[0]
    dev = ori.device
    sky = constant(tuple(cfg.sky_color), torch.float32, dev)
    ray_keys = None
    if seed_row is not None:
        # The ray index is folded in before the noise sample, so the
        # samples of one pixel (which share a texel) draw apart.
        seed_ints = (seed_row * float(1 << 24)).to(torch.int32)
        idx_ints = torch.arange(n_rays, dtype=torch.int32, device=dev)
        ray_keys = prng.fold_in(prng.fold_in(key, idx_ints), seed_ints)

    n_planes, n_sph = prims.num_planes, prims.num_spheres
    if n_sph:
        albedo_all = torch.cat([prims.color, prims.sph_color])
        em_all = torch.cat([prims.emission, prims.sph_emission])
        mir_all = torch.cat([prims.is_mirror, prims.sph_is_mirror])
    has_tex = prims.tex is not None
    if has_tex:
        tex_all = torch.cat([prims.tex, prims.sph_tex]) if n_sph else prims.tex
    has_glass = prims.ior is not None or prims.sph_ior is not None
    if has_glass:
        ior_p = prims.ior if prims.ior is not None else torch.zeros(
            n_planes, dtype=torch.float32, device=dev)
        ior_all = ior_p
        if n_sph:
            ior_s = prims.sph_ior if prims.sph_ior is not None else torch.zeros(
                n_sph, dtype=torch.float32, device=dev)
            ior_all = torch.cat([ior_p, ior_s])

    o, d = ori, dirs
    thr = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    light = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    mh = torch.zeros((n_rays,), dtype=torch.int32, device=dev)
    dc = torch.zeros((n_rays,), dtype=torch.int32, device=dev)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=dev)
    for it in range(cfg.max_segments):
        t, idx = nearest_fn(o, d)
        hit = alive & (t < BIG)
        ix = idx.long()
        if n_sph:
            albedo, em, mir = albedo_all[ix], em_all[ix], mir_all[ix]
            # A sphere's normal is (hit - c) / r; the gathers are clipped so
            # each side reads a valid row and the select keeps the right one.
            si = ix - n_planes
            is_s = si >= 0
            sc = prims.sph_center[si.clamp(0, n_sph - 1)]
            inv_r = prims.sph_inv_r[si.clamp(0, n_sph - 1)]
            hit_p = o + d * t[:, None]
            n = torch.where(is_s[:, None], (hit_p - sc) * inv_r[:, None],
                            prims.normal[ix.clamp(max=n_planes - 1)])
        else:
            n, albedo = prims.normal[ix], prims.color[ix]
            em, mir = prims.emission[ix], prims.is_mirror[ix]
        if has_tex:
            # Checker albedo swap: UV cells (kind 1) or world cells (kind 2).
            tx = tex_all[ix]
            tk, tsc, c2 = tx[:, 0], tx[:, 1], tx[:, 2:5]
            hit_t = o + d * t[:, None]
            pidx = ix.clamp(max=n_planes - 1)
            s1t = dot(hit_t, prims.w1[pidx]) - prims.b1[pidx]
            s2t = dot(hit_t, prims.w2[pidx]) - prims.b2[pidx]
            f1 = torch.floor(s1t * tsc) + torch.floor(s2t * tsc)
            f2 = ((torch.floor(hit_t[:, 0] / tsc) + torch.floor(hit_t[:, 1] / tsc))
                  + torch.floor(hit_t[:, 2] / tsc))
            f = torch.where(tk > 1.5, f2, f1)
            odd = (f - 2.0 * torch.floor(f * 0.5)) > 0.5
            albedo = torch.where(((tk > 0.0) & odd)[:, None], c2, albedo)

        side = -torch.sign(dot(d, n))
        diffuse = hit & (~mir | (side == -1.0))
        mirror = hit & mir & (side != -1.0)
        if has_glass:
            glass = hit & (ior_all[ix] > 0.0)
            diffuse = diffuse & ~glass
            mirror = mirror & ~glass
            spec = mirror | glass
        else:
            spec = mirror
        mh_new = mh + spec.to(torch.int32)
        mirror_live = mirror & (mh_new < cfg.mirror_limit)
        advance = diffuse | mirror_live
        if has_glass:
            glass_live = glass & (mh_new < cfg.mirror_limit)
            advance = advance | glass_live

        # Diffuse scatter (`shaders.metal:311-323`).
        if ray_keys is None:
            rnd = unit_sphere(prng.fold_in(key, it), (n_rays,))
        else:
            it_keys = prng.fold_in(ray_keys, it)
            rnd = unit_sphere(it_keys, ())
        scat = normalize(rnd + n * side[:, None])
        light = torch.where(diffuse[:, None], light + em[:, :3] * em[:, 3:4] * thr, light)
        thr = torch.where(diffuse[:, None], thr * albedo, thr)

        # Mirror reflection and its flat tint (`shaders.metal:324-330`).
        light = torch.where(mirror_live[:, None], light + albedo * cfg.mirror_tint, light)
        refl = normalize(reflect(d, n))

        if has_glass:
            # Snell on the unit direction; n_eff faces against the ray,
            # entering refracts at 1/ior, leaving at ior.
            ior_r = ior_all[ix]
            dhat = normalize(d)
            n_eff = n * side[:, None]
            cos_i = torch.clamp(-dot(dhat, n_eff), 0.0, 1.0)
            eta = torch.where(side > 0.0, 1.0 / torch.clamp_min(ior_r, 1e-6), ior_r)
            sin2t = eta * eta * (1.0 - cos_i * cos_i)
            tir = sin2t > 1.0
            if cfg.fresnel:
                q = (1.0 - eta) / (1.0 + eta)
                r0 = q * q
                reflect_p = torch.where(tir, 1.0, r0 + (1.0 - r0) * _pow5(1.0 - cos_i))
                if ray_keys is None:
                    u3 = prng.uniform(prng.fold_in(prng.fold_in(key, it), 1), (n_rays,))
                else:
                    u3 = prng.uniform(prng.fold_in(it_keys, 1), ())
                do_refl = u3 < reflect_p
            else:
                do_refl = tir
            refr = (eta[:, None] * dhat
                    + (eta * cos_i - sqrt(torch.clamp_min(1.0 - sin2t, 0.0)))[:, None]
                    * n_eff)
            gdir = normalize(torch.where(do_refl[:, None], reflect(dhat, n), refr))
            thr = torch.where(glass_live[:, None], thr * albedo, thr)

        # Miss: the sky term (`shaders.metal:336-339`).
        miss = alive & ~hit
        fall = torch.pow(cfg.lighting_factor, (it - mh).to(torch.float32))
        sky_term = sky * fall[:, None] * cfg.sky_strength
        light = torch.where(miss[:, None], light + sky_term, light)

        o = torch.where(advance[:, None], o + d * t[:, None], o)
        d = torch.where(diffuse[:, None], scat, torch.where(mirror_live[:, None], refl, d))
        if has_glass:
            d = torch.where(glass_live[:, None], gdir, d)
        dc = dc + diffuse.to(torch.int32)
        mh = mh_new
        # `n < bounce_limit + mirror_hits` (`shaders.metal:306`) as liveness.
        alive = (alive & ~miss & ~(spec & (mh_new >= cfg.mirror_limit))
                 & (dc < cfg.bounce_limit))
    return light


def tone_map(light: torch.Tensor) -> torch.Tensor:
    """Per-sample gamma before averaging (`shaders.metal:344`):
    sqrt(max(light, 0))."""
    return sqrt(torch.clamp_min(light, 0.0))
