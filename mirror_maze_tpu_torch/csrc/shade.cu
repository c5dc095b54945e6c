// Shade: one segment of the jnp tracer's bounce loop after its nearest-hit
// call, one thread a ray, for every ray still alive.
//
// Replaces the segment body of the JAX package's
// mirror_maze_tpu/render/tracer.py::trace_paths (`body`, run by
// `jax.lax.fori_loop`; XLA fuses it under jit, no Pallas kernel). Its plain
// version is the port's render/tracer.py shade_segment_plain, a masked vector
// pass over every ray in ~120 torch kernels; every update there is gated by
// the ray's `alive`, so a ray that is not alive keeps its state, and this
// kernel does not touch it.
//
// Per alive ray, from its nearest hit (t, idx; t = 1e30 is a miss):
// - the gathers by idx: normal, albedo, emission, mirror flag, ior, texture
//   row; a sphere's normal is (o + d t - c) * inv_r;
// - the checker swap (kind 1 UV cells, kind 2 world cells);
// - side = -sign(d.n); diffuse, mirror (under mirror_limit) or glass;
// - diffuse: light += (em.rgb * em.a) * thr, thr *= albedo, d = the scatter
//   normalize(u + n * side), u the unit vector finished here from the raw
//   normal draw g (ops/sampling.py unit_from_normals);
// - mirror: light += albedo * mirror_tint, d = normalize(reflect(d, n));
// - glass: Snell, Schlick's term against the uniform u3 with fresnel on (else
//   total internal reflection only), thr *= albedo, d = the chosen direction;
// - a miss: light += (sky * lighting_factor^(it - mh)) * sky_strength, the
//   power read from a table the wrapper made with torch.pow on this device;
// - o advances to the hit, mh and dc count, alive is the loop's rule;
// and, with an id list, the rays that stay alive are appended to it (warp by
// warp, one atomicAdd a warp), the list the next segment's walk reads.
//
// Exactness against the plain version (built with -fmad=false and IEEE
// division and square root, as every kernel of the port): one rounding an op
// in the order of the torch expressions: dots (a0*b0 + a1*b1) + a2*b2,
// light + (em.rgb * em.a) * thr, d - (2 * dot) * n, (sky * fall) * strength,
// r0 + (1 - r0) * (x * ((x * x) * (x * x))), 1 / max(ior, 1e-6) as an IEEE
// division (torch's 1.0 / x is reciprocal(x) * 1.0), normalize as a division
// by the correctly rounded root; prng.fma (the squared length of g) is a
// float64 product and add rounded once to float32, never fmaf. torch.sign is
// 0 for +-0 and NaN, so side is -0.0 there; torch.clamp passes NaN through,
// fminf / fmaxf do not, so the NaN test is written before them.
//
// Bound: bytes. An alive ray reads ~70 B of state and draws and writes ~60 B;
// a dead one costs the read of its alive byte; the scene's rows stay in the
// L1 / L2. The design is the simplest one: a block per 128 rays, state
// loaded as scalars (each warp reads whole 128 B lines of every array), and
// the stages template parameters, so the config_interactive maze runs a
// planes-only instance with no sphere, texture or glass code.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int THREADS = 128;
constexpr int TEX_WIDTH = 5;  // kind, scale, color2 rgb (render/scenebuf.py ScenePrims)

// The C entry's parameters (the wrapper's ctypes Structure in
// render/tracer.py, field for field: pointers, then ints, then floats).
struct Params {
  // The scene in scene order: planes [P, *] then spheres [S, *].
  const float* normal;      // [P, 3]
  const float* color;       // [P, 3]
  const float* emission;    // [P, 4]
  const bool* is_mirror;    // [P]
  const float* ior;         // [P] or null
  const float* tex;         // [P, 5] or null
  const float* w1;          // [P, 3] (texture stage)
  const float* b1;          // [P]
  const float* w2;          // [P, 3]
  const float* b2;          // [P]
  const float* sph_center;  // [S, 3]
  const float* sph_inv_r;   // [S]
  const float* sph_color;   // [S, 3]
  const float* sph_emission;  // [S, 4]
  const bool* sph_is_mirror;  // [S]
  const float* sph_ior;     // [S] or null
  const float* sph_tex;     // [S, 5] or null
  const float* pow_table;   // [segments + 1]: lighting_factor^k
  // The segment's inputs.
  const float* t;           // [R]
  const int* idx;           // [R]
  const float* g;           // [R, 3] raw normal draws
  const float* u3;          // [R] Fresnel uniforms, or null
  // The path state, read from the first set and written to the second (the
  // same pointers: in place). Only the rays alive on input are written.
  const float* o_in;
  const float* d_in;
  const float* thr_in;
  const float* light_in;
  const int* mh_in;
  const int* dc_in;
  const bool* alive_in;
  float* o;
  float* d;
  float* thr;
  float* light;
  int* mh;
  int* dc;
  bool* alive;
  int* ids;                 // [R] live-id list, or null
  int* count;               // its length on the device
  int n_rays;
  int n_planes;
  int n_spheres;
  int segment;
  int mirror_limit;
  int bounce_limit;
  float mirror_tint;
  float sky_r, sky_g, sky_b;
  float sky_strength;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
// ops/vecmath.py normalize: a / sqrt(dot(a, a)).
__device__ __forceinline__ V3 normalize(V3 a) {
  const float n = __fsqrt_rn(dot(a, a));
  return {a.x / n, a.y / n, a.z / n};
}
// ops/vecmath.py reflect: d - (2 * dot(d, n)) * n.
__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return sub(d, scale(n, 2.0f * dot(d, n))); }
// torch.clamp_min / torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// ops/prng.py fma: a * b + c in float64 (the product of two floats is exact
// there), rounded once to float32.
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// One alive ray's segment; returns whether it stays alive.
template <bool SPHERES, bool TEX, bool GLASS, bool FRESNEL>
__device__ __forceinline__ bool shade_ray(const Params& p, int r) {
  V3 o = load3(p.o_in, r), d = load3(p.d_in, r);
  V3 thr = load3(p.thr_in, r), light = load3(p.light_in, r);
  const int mh = p.mh_in[r];
  int dc = p.dc_in[r];
  const float t = p.t[r];
  bool keep;
  if (t < BIG) {
    // A hit: its primitive's rows (a sphere is scene id n_planes + i).
    const int ix = min(max(p.idx[r], 0), p.n_planes + p.n_spheres - 1);
    const V3 dt = scale(d, t);
    const V3 hit = add(o, dt);
    V3 n, albedo;
    const float* em;
    bool mir;
    float ior = 0.0f;
    const float* tx = nullptr;
    if (SPHERES && ix >= p.n_planes) {
      const int s = ix - p.n_planes;
      n = scale(sub(hit, load3(p.sph_center, s)), p.sph_inv_r[s]);
      albedo = load3(p.sph_color, s);
      em = p.sph_emission + 4 * s;
      mir = p.sph_is_mirror[s];
      if (GLASS && p.sph_ior != nullptr) ior = p.sph_ior[s];
      if (TEX) tx = p.sph_tex + TEX_WIDTH * s;
    } else {
      n = load3(p.normal, ix);
      albedo = load3(p.color, ix);
      em = p.emission + 4 * ix;
      mir = p.is_mirror[ix];
      if (GLASS && p.ior != nullptr) ior = p.ior[ix];
      if (TEX) tx = p.tex + TEX_WIDTH * ix;
    }
    if (TEX) {
      // The checker swap: UV cells of the plane's edge coordinates (kind 1)
      // or world cells (kind 2); a sphere reads the last plane's edges.
      const float tk = tx[0], tsc = tx[1];
      const int pi = min(ix, p.n_planes - 1);
      const float s1 = dot(hit, load3(p.w1, pi)) - p.b1[pi];
      const float s2 = dot(hit, load3(p.w2, pi)) - p.b2[pi];
      const float f1 = floorf(s1 * tsc) + floorf(s2 * tsc);
      const float f2 = (floorf(hit.x / tsc) + floorf(hit.y / tsc)) + floorf(hit.z / tsc);
      const float f = tk > 1.5f ? f2 : f1;
      const bool odd = (f - 2.0f * floorf(f * 0.5f)) > 0.5f;
      if (tk > 0.0f && odd) albedo = {tx[2], tx[3], tx[4]};
    }
    const float dn = dot(d, n);
    const float side = dn > 0.0f ? -1.0f : (dn < 0.0f ? 1.0f : -0.0f);
    const bool glass = GLASS && ior > 0.0f;
    const bool diffuse = !glass && (!mir || side == -1.0f);
    const bool mirror = !glass && mir && side != -1.0f;
    const int mh_new = mh + ((mirror || glass) ? 1 : 0);
    const bool under = mh_new < p.mirror_limit;
    V3 d_new = d;
    if (diffuse) {
      const V3 gr = load3(p.g, r);
      const float sq = fma64(gr.z, gr.z, fma64(gr.y, gr.y, gr.x * gr.x));
      const float len = clamp_min(__fsqrt_rn(sq), 1e-12f);
      const V3 u = {gr.x / len, gr.y / len, gr.z / len};
      d_new = normalize(add(u, scale(n, side)));
      light = add(light, mul(scale({em[0], em[1], em[2]}, em[3]), thr));
      thr = mul(thr, albedo);
      ++dc;
    } else if (mirror) {
      if (under) {
        light = add(light, scale(albedo, p.mirror_tint));
        d_new = normalize(reflect(d, n));
      }
    } else if (GLASS && under) {
      // Snell on the unit direction; n_eff faces against the ray, entering
      // refracts at 1/ior, leaving at ior.
      const V3 dh = normalize(d);
      const V3 n_eff = scale(n, side);
      const float cos_i = clamp(-dot(dh, n_eff), 0.0f, 1.0f);
      const float eta = side > 0.0f ? 1.0f / clamp_min(ior, 1e-6f) : ior;
      const float sin2t = (eta * eta) * (1.0f - cos_i * cos_i);
      const bool tir = sin2t > 1.0f;
      bool do_refl = tir;
      if (FRESNEL) {
        const float q = (1.0f - eta) / (1.0f + eta);
        const float r0 = q * q;
        const float x = 1.0f - cos_i;
        const float x2 = x * x;
        const float reflect_p = tir ? 1.0f : r0 + (1.0f - r0) * (x * (x2 * x2));
        do_refl = p.u3[r] < reflect_p;
      }
      const float k = eta * cos_i - __fsqrt_rn(clamp_min(1.0f - sin2t, 0.0f));
      const V3 refr = add(scale(dh, eta), scale(n_eff, k));
      d_new = normalize(do_refl ? reflect(dh, n) : refr);
      thr = mul(thr, albedo);
    }
    if (diffuse || under) o = add(o, dt);
    d = d_new;
    keep = !((mirror || glass) && !under) && dc < p.bounce_limit;
    p.mh[r] = mh_new;
  } else {
    // A miss: the sky term, and the ray ends.
    const float fall = p.pow_table[p.segment - mh];
    light.x = light.x + (p.sky_r * fall) * p.sky_strength;
    light.y = light.y + (p.sky_g * fall) * p.sky_strength;
    light.z = light.z + (p.sky_b * fall) * p.sky_strength;
    keep = false;
    p.mh[r] = mh;
  }
  store3(p.o, r, o);
  store3(p.d, r, d);
  store3(p.thr, r, thr);
  store3(p.light, r, light);
  p.dc[r] = dc;
  p.alive[r] = keep;
  return keep;
}

template <bool SPHERES, bool TEX, bool GLASS, bool FRESNEL>
__global__ void __launch_bounds__(THREADS) shade_kernel(const Params p) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  bool keep = false;
  if (r < p.n_rays && p.alive_in[r]) keep = shade_ray<SPHERES, TEX, GLASS, FRESNEL>(p, r);
  if (p.ids != nullptr) {
    // Every lane reaches the ballot (no lane returned above): the warp's
    // survivors take consecutive slots from one atomicAdd, in lane order.
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (kept != 0u) {
      const int lane = threadIdx.x & 31;
      const int leader = __ffs(kept) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(p.count, __popc(kept));
      base = __shfl_sync(0xffffffffu, base, leader);
      const int pos = base + __popc(kept & ((1u << lane) - 1u));
      if (keep && pos < p.n_rays) p.ids[pos] = r;
    }
  }
}

template <bool SPHERES, bool TEX>
int launch_glass(const Params& p, bool glass, bool fresnel, int blocks, cudaStream_t stream) {
  if (!glass)
    shade_kernel<SPHERES, TEX, false, false><<<blocks, THREADS, 0, stream>>>(p);
  else if (!fresnel)
    shade_kernel<SPHERES, TEX, true, false><<<blocks, THREADS, 0, stream>>>(p);
  else
    shade_kernel<SPHERES, TEX, true, true><<<blocks, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// params: a Params (the type has internal linkage, so the C interface takes
// its address untyped). glass / fresnel: the scene has glass, and Schlick's
// split is on (then u3 is read). spheres and textures follow from the counts
// and the pointers.
extern "C" int mm_shade(const void* params, int glass, int fresnel, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  const bool spheres = p.n_spheres > 0, tex = p.tex != nullptr;
  if (p.n_rays < 0 || p.n_planes < 1 || p.n_spheres < 0 || (spheres && tex && !p.sph_tex) ||
      (glass && fresnel && p.u3 == nullptr) || (p.ids != nullptr) != (p.count != nullptr))
    return (int)cudaErrorInvalidValue;
  if (p.n_rays == 0) return (int)cudaGetLastError();
  const int blocks = (p.n_rays + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (spheres)
    return tex ? launch_glass<true, true>(p, glass, fresnel, blocks, s)
               : launch_glass<true, false>(p, glass, fresnel, blocks, s);
  return tex ? launch_glass<false, true>(p, glass, fresnel, blocks, s)
             : launch_glass<false, false>(p, glass, fresnel, blocks, s);
}
