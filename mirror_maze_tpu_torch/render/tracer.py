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

A segment is the nearest-hit call, the draws (``segment_draws``: the raw
normal triples and the Fresnel uniforms, launches of the threefry kernel on
the card; from the second segment on the card draws the triples of the
listed rays alone) and the shading of every ray still alive. On
a CPU tensor the shading is ``shade_segment_plain``, a masked pass over
every ray in torch ops. On a CUDA tensor it is ``shade_segment_kernel``, one
launch of the hand-written kernel ``csrc/shade.cu`` (bitwise the plain
version), which updates the path state in place and appends the rays that
stay alive to a live-id list: the next segment's ``nearest_fn(o, d,
live=(ids, count))`` may walk only those (the bvh kernel does; the dense
backends test every ray). Every update of the plain version is masked by
``alive``, so a ray that is not alive is left as it is, its t, idx and
normal triple are never read, and the light does not depend on which backend
reads the list.
The count lives on the device, one int32 a segment made for each call, so
a CUDA graph holds the whole loop. There is no fallback: on a CUDA tensor a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from .. import kernels
from ..config import TracerConfig
from ..device import check_live_list, constant
from ..ops import prng
from ..ops.sampling import unit_from_normals
from ..ops.vecmath import dot, normalize, reflect, sqrt
from .intersect import BIG, nearest_hit_brute
from .scenebuf import ScenePrims

# fn(o, d) -> (t, idx); on the card trace_paths calls fn(o, d, live=(ids,
# count)) from the second segment on (render/pipeline.py make_nearest_fn).
NearestFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]


def _pow5(x: torch.Tensor) -> torch.Tensor:
    """x^5 as jax's integer_pow multiplies it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


class PathState(NamedTuple):
    """The bounce loop's per-ray state: position and direction, throughput
    and gathered light [R, 3] float32, mirror hits and diffuse bounces [R]
    int32, liveness [R] bool."""

    o: torch.Tensor
    d: torch.Tensor
    thr: torch.Tensor
    light: torch.Tensor
    mh: torch.Tensor
    dc: torch.Tensor
    alive: torch.Tensor


def path_start(ori: torch.Tensor, dirs: torch.Tensor) -> PathState:
    """Every ray alive at its camera origin and direction (copies, which the
    kernel updates in place), throughput 1, no light, no hits."""
    n_rays, dev = ori.shape[0], ori.device
    return PathState(
        ori.clone(memory_format=torch.contiguous_format),
        dirs.clone(memory_format=torch.contiguous_format),
        torch.ones((n_rays, 3), dtype=torch.float32, device=dev),
        torch.zeros((n_rays, 3), dtype=torch.float32, device=dev),
        torch.zeros((n_rays,), dtype=torch.int32, device=dev),
        torch.zeros((n_rays,), dtype=torch.int32, device=dev),
        torch.ones((n_rays,), dtype=torch.bool, device=dev))


def has_glass(prims: ScenePrims) -> bool:
    """Whether the scene has glass (an ior column): the glass stage runs."""
    return prims.ior is not None or prims.sph_ior is not None


def seed_row_keys(key: torch.Tensor, seed_row: torch.Tensor) -> torch.Tensor:
    """The per-ray keys [R, 2] of a seed row [R]: ray i's key is
    fold_in(fold_in(key, i), int(seed_row[i] * 2^24)). The ray index is
    folded in before the noise sample, so the samples of one pixel (which
    share a texel) draw apart."""
    seed_ints = (seed_row * float(1 << 24)).to(torch.int32)
    idx_ints = torch.arange(seed_row.shape[0], dtype=torch.int32, device=seed_row.device)
    return prng.fold_in(prng.fold_in(key, idx_ints), seed_ints)


def segment_draws(key: torch.Tensor, ray_keys: torch.Tensor | None, it: int, n_rays: int,
                  fresnel: bool, rows: tuple | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Segment ``it``'s draws: the raw normal triples g [R, 3] that the
    diffuse scatter's unit vectors are made from (``unit_sphere``'s draw),
    from ``fold_in(key, it)`` or per ray from ``fold_in(ray_keys, it)``; and
    with ``fresnel`` (glass with Schlick's split) the uniforms [R] from
    ``fold_in(that key, 1)``, else None. With ``rows = (ids, count)``, the
    segment's live-id list, the card draws g only at the listed rays (each
    row bitwise the full draw's; the others unwritten, and the shade reads
    none of them); u3 is drawn for every ray."""
    if ray_keys is None:
        seg_key = prng.fold_in(key, it)
        g = prng.normal(seg_key, (n_rays, 3), rows=rows)
        u3 = prng.uniform(prng.fold_in(seg_key, 1), (n_rays,)) if fresnel else None
    else:
        it_keys = prng.fold_in(ray_keys, it)
        g = prng.normal(it_keys, (3,), rows=rows)
        u3 = prng.uniform(prng.fold_in(it_keys, 1), ()) if fresnel else None
    return g, u3


def shade_segment_plain(prims: ScenePrims, cfg: TracerConfig, st: PathState, t: torch.Tensor,
                        idx: torch.Tensor, g: torch.Tensor, u3: torch.Tensor | None,
                        it: int) -> PathState:
    """The plain version of ``shade_segment_kernel``: segment ``it`` of the
    bounce loop after its nearest-hit call (t [R], idx [R] int32), every ray
    masked by its liveness; returns the new state."""
    o, d, thr, light, mh, dc, alive = st
    dev = o.device
    sky = constant(tuple(cfg.sky_color), torch.float32, dev)
    n_planes, n_sph = prims.num_planes, prims.num_spheres
    if n_sph:
        albedo_all = torch.cat([prims.color, prims.sph_color])
        em_all = torch.cat([prims.emission, prims.sph_emission])
        mir_all = torch.cat([prims.is_mirror, prims.sph_is_mirror])
    has_tex = prims.tex is not None
    if has_tex:
        tex_all = torch.cat([prims.tex, prims.sph_tex]) if n_sph else prims.tex
    glassy = has_glass(prims)
    if glassy:
        ior_p = prims.ior if prims.ior is not None else torch.zeros(
            n_planes, dtype=torch.float32, device=dev)
        ior_all = ior_p
        if n_sph:
            ior_s = prims.sph_ior if prims.sph_ior is not None else torch.zeros(
                n_sph, dtype=torch.float32, device=dev)
            ior_all = torch.cat([ior_p, ior_s])

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
    if glassy:
        glass = hit & (ior_all[ix] > 0.0)
        diffuse = diffuse & ~glass
        mirror = mirror & ~glass
        spec = mirror | glass
    else:
        spec = mirror
    mh_new = mh + spec.to(torch.int32)
    mirror_live = mirror & (mh_new < cfg.mirror_limit)
    advance = diffuse | mirror_live
    if glassy:
        glass_live = glass & (mh_new < cfg.mirror_limit)
        advance = advance | glass_live

    # Diffuse scatter (`shaders.metal:311-323`).
    rnd = unit_from_normals(g)
    scat = normalize(rnd + n * side[:, None])
    light = torch.where(diffuse[:, None], light + em[:, :3] * em[:, 3:4] * thr, light)
    thr = torch.where(diffuse[:, None], thr * albedo, thr)

    # Mirror reflection and its flat tint (`shaders.metal:324-330`).
    light = torch.where(mirror_live[:, None], light + albedo * cfg.mirror_tint, light)
    refl = normalize(reflect(d, n))

    if glassy:
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
    if glassy:
        d = torch.where(glass_live[:, None], gdir, d)
    dc = dc + diffuse.to(torch.int32)
    # `n < bounce_limit + mirror_hits` (`shaders.metal:306`) as liveness.
    alive = (alive & ~miss & ~(spec & (mh_new >= cfg.mirror_limit))
             & (dc < cfg.bounce_limit))
    return PathState(o, d, thr, light, mh_new, dc, alive)


_powers: dict = {}


def lighting_powers(factor: float, n: int, device) -> torch.Tensor:
    """lighting_factor^k for k = 0..n-1, float32 [n], as the plain version's
    ``torch.pow`` computes them on ``device``; made once per (factor, n,
    device) and shared, READ-ONLY. It is made where no CUDA graph is being
    captured (a capture would record it and leave the cache unwritten):
    the step runs each input kind's first frame eagerly before capturing it
    (runtime/graph.py)."""
    key = (float(factor), int(n), torch.device(device))
    table = _powers.get(key)
    if table is None:
        if key[2].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the lighting powers are made outside a CUDA graph capture: "
                               "trace one segment loop eagerly before capturing it")
        exponents = torch.arange(n, dtype=torch.float32, device=device)
        table = _powers[key] = torch.pow(float(factor), exponents)
    return table


# The kernel's parameters (csrc/shade.cu Params), field for field.
_SHADE_POINTERS = (
    "normal", "color", "emission", "is_mirror", "ior", "tex", "w1", "b1", "w2", "b2",
    "sph_center", "sph_inv_r", "sph_color", "sph_emission", "sph_is_mirror", "sph_ior",
    "sph_tex", "pow_table", "t", "idx", "g", "u3",
    "o_in", "d_in", "thr_in", "light_in", "mh_in", "dc_in", "alive_in",
    "o", "d", "thr", "light", "mh", "dc", "alive", "ids", "count")
_SHADE_INTS = ("n_rays", "n_planes", "n_spheres", "segment", "mirror_limit", "bounce_limit")
_SHADE_FLOATS = ("mirror_tint", "sky_r", "sky_g", "sky_b", "sky_strength")


class _ShadeParams(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in _SHADE_POINTERS]
                + [(f, ctypes.c_int) for f in _SHADE_INTS]
                + [(f, ctypes.c_float) for f in _SHADE_FLOATS])


def _operand(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> int:
    """x's data pointer, after checking that it is a contiguous ``dtype``
    tensor of ``shape`` on ``device``."""
    if (x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device
            or not x.is_contiguous()):
        raise ValueError(f"the shade kernel takes {name} as contiguous {dtype} {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return x.data_ptr()


def shade_segment_kernel(prims: ScenePrims, cfg: TracerConfig, st: PathState, t: torch.Tensor,
                         idx: torch.Tensor, g: torch.Tensor, u3: torch.Tensor | None, it: int,
                         live_out: tuple | None = None,
                         out: PathState | None = None) -> PathState:
    """Segment ``it`` of the bounce loop in one launch of the ``shade``
    kernel (csrc/shade.cu): bitwise ``shade_segment_plain`` on every ray
    alive in ``st``. The new state is written into ``out`` (default ``st``:
    in place); only the rays alive in ``st`` are written, so ``out`` must hold
    the others' state already. With ``live_out = (ids, count)`` (int32 [R]
    and int32 [1], the count 0) the rays that stay alive are appended to the
    list, in no fixed order. u3 (the Fresnel uniforms) is read where the
    scene has glass and ``cfg.fresnel`` is on. Raises on tensors that are not
    on a CUDA device and on malformed operands; there is no fallback to the
    plain version."""
    n_rays = st.o.shape[0]
    dev = st.o.device
    if live_out is not None:
        check_live_list(*live_out, n_rays, dev)
    if dev.type != "cuda":
        raise ValueError(f"the shade kernel runs on CUDA tensors, got {dev}; "
                         "shade_segment_plain is the plain version")
    if not 0 <= it < cfg.max_segments:
        raise ValueError(f"segment {it} of a loop of {cfg.max_segments}")
    out = st if out is None else out
    glassy = has_glass(prims)
    fresnel = glassy and cfg.fresnel
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    p = _ShadeParams()
    shapes = {"o": (f32, 3), "d": (f32, 3), "thr": (f32, 3), "light": (f32, 3),
              "mh": (i32, 0), "dc": (i32, 0), "alive": (b8, 0)}
    for name, (dtype, width) in shapes.items():
        shape = (n_rays, width) if width else (n_rays,)
        setattr(p, name + "_in", _operand(name, getattr(st, name), dtype, shape, dev))
        setattr(p, name, _operand(name, getattr(out, name), dtype, shape, dev))
    p.t = _operand("t", t, f32, (n_rays,), dev)
    p.idx = _operand("idx", idx, i32, (n_rays,), dev)
    p.g = _operand("g", g, f32, (n_rays, 3), dev)
    if fresnel:
        if u3 is None:
            raise ValueError("the shade kernel needs the Fresnel uniforms u3 for glass with "
                             "fresnel on")
        p.u3 = _operand("u3", u3, f32, (n_rays,), dev)
    n_planes, n_sph = prims.num_planes, prims.num_spheres
    scene = [("normal", prims.normal, f32, (n_planes, 3)),
             ("color", prims.color, f32, (n_planes, 3)),
             ("emission", prims.emission, f32, (n_planes, 4)),
             ("is_mirror", prims.is_mirror, b8, (n_planes,))]
    if prims.tex is not None:
        scene += [("tex", prims.tex, f32, (n_planes, 5)), ("w1", prims.w1, f32, (n_planes, 3)),
                  ("b1", prims.b1, f32, (n_planes,)), ("w2", prims.w2, f32, (n_planes, 3)),
                  ("b2", prims.b2, f32, (n_planes,))]
    if prims.ior is not None:
        scene.append(("ior", prims.ior, f32, (n_planes,)))
    if n_sph:
        scene += [("sph_center", prims.sph_center, f32, (n_sph, 3)),
                  ("sph_inv_r", prims.sph_inv_r, f32, (n_sph,)),
                  ("sph_color", prims.sph_color, f32, (n_sph, 3)),
                  ("sph_emission", prims.sph_emission, f32, (n_sph, 4)),
                  ("sph_is_mirror", prims.sph_is_mirror, b8, (n_sph,))]
        if prims.sph_ior is not None:
            scene.append(("sph_ior", prims.sph_ior, f32, (n_sph,)))
        if prims.tex is not None:
            scene.append(("sph_tex", prims.sph_tex, f32, (n_sph, 5)))
    for name, x, dtype, shape in scene:
        setattr(p, name, _operand(name, x, dtype, shape, dev))
    p.pow_table = lighting_powers(cfg.lighting_factor, cfg.max_segments + 1, dev).data_ptr()
    if live_out is not None:
        p.ids, p.count = (x.data_ptr() for x in live_out)
    p.n_rays, p.n_planes, p.n_spheres, p.segment = n_rays, n_planes, n_sph, it
    p.mirror_limit, p.bounce_limit = cfg.mirror_limit, cfg.bounce_limit
    p.mirror_tint, p.sky_strength = cfg.mirror_tint, cfg.sky_strength
    p.sky_r, p.sky_g, p.sky_b = cfg.sky_color
    with torch.cuda.device(dev):            # the launch goes to this device's stream
        kernels.launch("shade", ctypes.addressof(p), int(glassy), int(fresnel))
    return out


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
    the backend (``nearest_hit_brute`` when None); on the card it is called
    with ``live=(ids, count)`` from the second segment on, the rays alive
    there (it may walk only those), and the segment's normal triples are
    drawn for those rays alone. The shading is the kernel on a CUDA tensor
    and the plain version on a CPU tensor."""
    if nearest_fn is None:
        nearest_fn = lambda o, d, live=None: nearest_hit_brute(prims, o, d, cfg.t_min)  # noqa: E731
    n_rays = ori.shape[0]
    dev = ori.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"trace_paths runs on cuda or cpu tensors, got {dev}")
    on_card = dev.type == "cuda"
    ray_keys = None if seed_row is None else seed_row_keys(key, seed_row)
    fresnel = has_glass(prims) and cfg.fresnel

    st = path_start(ori, dirs)
    if on_card:
        # One live-id list (a segment's walk reads it before the segment's
        # shade rewrites it) and a count for each segment, zeroed here.
        ids = torch.empty((n_rays,), dtype=torch.int32, device=dev)
        counts = torch.zeros((cfg.max_segments,), dtype=torch.int32, device=dev)
    for it in range(cfg.max_segments):
        if on_card and it > 0:
            # The rays alive here: the walk and the normal draw take only
            # those, whatever backend finds the hits.
            live = (ids, counts[it:it + 1])
            t, idx = nearest_fn(st.o, st.d, live=live)
        else:
            live = None
            t, idx = nearest_fn(st.o, st.d)
        g, u3 = segment_draws(key, ray_keys, it, n_rays, fresnel, rows=live)
        if on_card:
            last = it == cfg.max_segments - 1
            st = shade_segment_kernel(prims, cfg, st, t, idx, g, u3, it,
                                      live_out=None if last else (ids, counts[it + 1:it + 2]))
        else:
            st = shade_segment_plain(prims, cfg, st, t, idx, g, u3, it)
    return st.light


def tone_map(light: torch.Tensor) -> torch.Tensor:
    """Per-sample gamma before averaging (`shaders.metal:344`):
    sqrt(max(light, 0))."""
    return sqrt(torch.clamp_min(light, 0.0))
