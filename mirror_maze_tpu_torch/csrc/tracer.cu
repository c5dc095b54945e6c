// Fused path tracer: the whole bounce loop of one ray per CUDA thread.
//
// Replaces the JAX package's Pallas kernel
// mirror_maze_tpu/render/pallas_tracer.py::_tracer_kernel (launched by
// _trace_padded), for quads, triangles and spheres, opaque or glass, plain
// or checker-textured, in the reference's eight test modes (0: full quad
// test, 1: along-wall edge test only, 2: no edge test, 3: spheres, 4:
// triangles, 5: glass spheres, 6: glass quads, 7: glass triangles), in any
// number of tiles, with the noise seed row, the sky term and the per-block
// diagnostics (the reference's output rows 3-7). It computes what that
// kernel computes under the CPU interpreter, ray for ray
// (render/fused_tracer.py trace_paths_plain is the same function in
// PyTorch):
//
// - plane hit test: t = numer * (1/denom) (IEEE reciprocal, then a multiply
//   — not numer/denom), edge tests min(s, 1-s) >= 0 per tested edge of a
//   quad, min(s1, s2, 1 - (s1 + s2)) >= 0 for a triangle, t > t_min, misses
//   at BIG = 1e30;
// - sphere hit test: bq = D.O - D.c, q = |O|^2 + (|c|^2 - r^2 - 2 O.c),
//   disc = bq*bq - q, t = -bq - sqrt(max(disc, 0)), accepted when disc > 0
//   and t > t_min; a glass sphere takes the far root -bq + sqrt(...) when
//   the near one is not past t_min (the ray is inside). A sphere that wins
//   carries its centre in the normal's place, and the normal is rebuilt
//   after the nearest hit is known as ((o + d t) - c) * (1/r);
// - per segment, first the single-tile groups jointly: one nearest t over
//   all their primitives, and those that tie exactly on it SUM their
//   properties, as the reference's one-hot select does;
// - then the tiles of the multi-tile groups in the order the wrapper gives
//   (group with most tiles first, within a group nearest the camera first).
//   A tile's own nearest hit, ties inside the tile summed, replaces the
//   running one only where it is strictly nearer. Here that is one running
//   winner plus a flag `own` (the winner came from the tile being scanned):
//   a primitive strictly nearer replaces it and sets the flag, one that
//   ties adds to it only while the flag is set;
// - a tile is scanned only if the ray's slab test against the tile's box
//   (inflated at upload, entry and exit widened by a relative 1e-3) passes
//   nearer than the running hit; a ray that starts inside the box (inside a
//   glass sphere) has a negative entry and passes. The reference makes the
//   same test but skips per block of rays. For a ray inside the closed
//   world the test is conservative, and both are the same function;
//   render/fused_tracer.py says where they differ (rays that have left the
//   world);
// - emission pickup, albedo attenuation, mirror tint and reflection, the
//   diffuse scatter from one PCG word split into two 16-bit uniforms and
//   the reference's _sinpi polynomial, one 1/sqrt normalization; a live
//   miss gathers the sky term when its strength is not 0;
// - the dielectric stage, compiled only for a scene with a glass group: a
//   glass hit (ior > 0) is neither mirror nor diffuse and counts against
//   the mirror budget; on the unit direction, Snell refraction, total
//   internal reflection, and with `fresnel` the Schlick split r0 + (1 - r0)
//   (1 - cos)^5 decided by a third uniform (the top 24 bits of one more PCG
//   word), drawn after the scatter pair by every live ray on every segment
//   of such a scene, whatever it hit; throughput times albedo while under
//   budget, no emission, no mirror tint;
// - the PCG stream of ray i is seeded by (seed, pid = i / B, r = i % B)
//   with B the reference's rays per Pallas program, plus the ray's seed-row
//   value as a 24-bit integer, so the launch geometry here never changes
//   the image;
// - the texture stage, compiled only for a textured scene (MM_TEX): the
//   winner carries its texture row (kind, scale, second colour; read from
//   the texture tables, and only by a primitive that wins or ties) and its
//   w1, b1, w2, b2, tie-summed like every other property. After the nearest
//   hit and the sphere normal, with h = o + d t: kind 1 counts floor(s1
//   scale) + floor(s2 scale) with s = (h.w) - b, kind 2 floor(hx / scale) +
//   floor(hy / scale) + floor(hz / scale) (IEEE division); on an odd count
//   the albedo becomes the second colour, before any use of it;
// - the diagnostics, compiled only when asked for (MM_DIAG): per reference
//   block of B rays (ray i belongs to block i / B, threads of many CUDA
//   blocks share one), the most segments any of its rays lived (atomicMax)
//   and their sum (atomicAdd), and per block and segment one bit for every
//   walked tile that a live ray's slab test reached (atomicOr, tried only
//   while the bit reads as clear). The reference evaluates a tile for the
//   whole block when any live lane reaches it; the wrapper counts the bits.
//
// One source, four libraries: the macros MM_TEX and MM_DIAG (0 or 1, set on
// nvcc's command line) choose which of the two extra stages a translation
// unit instantiates, so a scene without textures traced without diagnostics
// runs the 16 instantiations it always ran and the others are built when
// first used.
//
// A lane that dies changes nothing in the reference's block-wide loop, so
// each thread simply stops at its own death.
//
// Bound on the card: operations. Each (ray, plane) test costs ~16 f32
// operations plus 16 per tested edge and one IEEE reciprocal, a sphere test
// ~20 and a square root; memory traffic is the rays in and the light out. A
// scene whose groups are all single-tile has its records (a few KB) staged
// in shared memory once per block, and every thread reads the same record
// at the same time (a broadcast). A multi-tile scene's records (215 KB for
// a 64x64 maze) stay in global memory and are read through the read-only
// path: a warp's threads walk the tiles in the same order and read the same
// record together, and the table lives in L2. Only the tile table and the
// walk order are staged. The stages a scene does not need are template
// parameters (PRIMS: triangles or spheres; GLASS), so a maze of opaque
// quads compiles the kernel it always had. Build with -fmad=false: a
// contracted multiply-add would round differently from the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MM_TEX
#define MM_TEX 0
#endif
#ifndef MM_DIAG
#define MM_DIAG 0
#endif

#define BIG 1e30f
#define RECORD 20  // floats per plane record (render/scenebuf.py RECORD_WIDTH)
#define RECORD4 5  // the same in float4s
#define SPHERE 16  // floats per sphere record (SPHERE_RECORD_WIDTH)
#define SPHERE4 4
#define TILE 9     // floats per tile row (render/scenebuf.py tile_table)
#define TEX4 2     // float4s per texture row (TEX_WIDTH)

struct Params {
  const float* ori;
  const float* dirs;
  const float* planes;    // [n_planes, RECORD]
  const float* spheres;   // [n_spheres, SPHERE]
  const float* tiles;     // [n_tiles, TILE]: box lo, box hi, first record, records, mode
  const int* order;       // [n_tiles - n_single] walk order of the other tiles
  const int* seed;
  const float* seed_row;  // [n_rays] in [0, 1), or null
  float* light;
  int n_planes, n_spheres, n_tiles, n_single;
  int n_rays, block_rays, max_segments, bounce_limit, mirror_limit, fresnel;
  float mirror_tint, t_min;
  float sky_r, sky_g, sky_b, sky_strength, sky_lf, sky_log_lf;
  // What only the TEX and DIAG kernels read stands last: the others' fields
  // keep their places, and their instantiations their registers.
  const float* plane_tex;   // [n_planes, 8] texture rows, or null (TEX kernels read them)
  const float* sphere_tex;  // [n_spheres, 8]
  int* diag_segments;       // [2, n_blocks]: max and sum of segments lived (DIAG kernels)
  unsigned int* diag_mask;  // [n_blocks, max_segments, mask_words] walked tiles reached
  int mask_words;
};

// The running nearest hit: t and the winner's (tie-summed) normal (a
// sphere's centre), albedo, emission and is_mirror; 1/r and the is-sphere
// flag (PRIMS kernels), the ior (GLASS kernels), and the texture row with
// the plane's w1, b1, w2, b2 (TEX kernels; zeros for a sphere).
struct Hit {
  float t, nx, ny, nz, cr, cg, cb, er, eg, eb, mir, inv_r, sph, ior;
  float tk, tsc, c2r, c2g, c2b, w1x, w1y, w1z, b1, w2x, w2y, w2z, b2;
};

// The winner's texture row and edge constants: set when a primitive wins,
// added when it ties. `tex` is the primitive's row of the texture table,
// `w1`/`w2` its (w, b) float4s, zeros for a sphere.
template <bool ADD>
__device__ __forceinline__ void carry_tex(Hit& h, const float4* tex, float4 w1, float4 w2) {
  const float4 a = __ldg(tex), b = __ldg(tex + 1);  // kind, scale, colour2 rg | b
  if (ADD) {
    h.tk += a.x; h.tsc += a.y; h.c2r += a.z; h.c2g += a.w; h.c2b += b.x;
    h.w1x += w1.x; h.w1y += w1.y; h.w1z += w1.z; h.b1 += w1.w;
    h.w2x += w2.x; h.w2y += w2.y; h.w2z += w2.z; h.b2 += w2.w;
  } else {
    h.tk = a.x; h.tsc = a.y; h.c2r = a.z; h.c2g = a.w; h.c2b = b.x;
    h.w1x = w1.x; h.w1y = w1.y; h.w1z = w1.z; h.b1 = w1.w;
    h.w2x = w2.x; h.w2y = w2.y; h.w2z = w2.z; h.b2 = w2.w;
  }
}

__device__ __forceinline__ uint32_t pcg_scramble(uint32_t& state) {
  state = state * 747796405u + 291336453u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// sin(pi * t) for t in [-0.5, 0.5]: the reference's odd minimax polynomial
// (3.14159099, -5.16747237, 2.54484882, -0.56204532), its coefficients
// written as the exact float32 values the reference computes with.
__device__ __forceinline__ float sinpi_poly(float t) {
  float t2 = t * t;
  return t * (0x1.921fa8p+1f +
              t2 * (-0x1.4ab7dep+2f + t2 * (0x1.45bd9cp+1f + t2 * -0x1.1fc468p-1f)));
}

template <bool STAGED>
__device__ __forceinline__ float4 load4(const float4* p) {
  if constexpr (STAGED) return *p;
  else return __ldg(p);
}

// Test `count` plane records of one mode from row `first` on against the
// ray and fold them into the running hit.
template <bool STAGED, int MODE, bool PRIMS, bool GLASS, bool TEX>
__device__ __forceinline__ void scan_rows(const float4* rec, const float4* tex, int first,
                                          int count,
                                          float ox, float oy, float oz, float dx,
                                          float dy, float dz, float t_min, Hit& h,
                                          bool& own) {
  constexpr bool TRIANGLE = MODE == 4 || MODE == 7;
  constexpr bool EDGE1 = MODE == 0 || MODE == 1 || MODE == 6;
  constexpr bool EDGE2 = MODE == 0 || MODE == 6;
  const float4* R = rec + (size_t)first * RECORD4;
  for (int k = 0; k < count; ++k, R += RECORD4) {
    const float4 a = load4<STAGED>(R);  // normal, d
    const float numer = a.w - ((a.x * ox + a.y * oy) + a.z * oz);
    const float denom = (a.x * dx + a.y * dy) + a.z * dz;
    const float t = numer * (1.0f / denom);
    bool ok = t > t_min;
    if (EDGE1 || TRIANGLE) {
      const float4 b = load4<STAGED>(R + 1);  // w1, b1
      const float s1 = (((b.x * ox + b.y * oy) + b.z * oz) - b.w) +
                       t * ((b.x * dx + b.y * dy) + b.z * dz);
      if (EDGE1) ok = ok && (s1 >= 0.f) && (1.0f - s1 >= 0.f);
      if (EDGE2 || TRIANGLE) {
        const float4 c = load4<STAGED>(R + 2);  // w2, b2
        const float s2 = (((c.x * ox + c.y * oy) + c.z * oz) - c.w) +
                         t * ((c.x * dx + c.y * dy) + c.z * dz);
        if (EDGE2) ok = ok && (s2 >= 0.f) && (1.0f - s2 >= 0.f);
        if (TRIANGLE) ok = ok && (s1 >= 0.f) && (s2 >= 0.f) && (1.0f - (s1 + s2) >= 0.f);
      }
    }
    const float tv = ok ? t : BIG;
    if (tv < h.t) {
      const float4 c = load4<STAGED>(R + 3);  // albedo, emission r
      const float4 e = load4<STAGED>(R + 4);  // emission g b, is_mirror, ior
      h.t = tv;
      h.nx = a.x; h.ny = a.y; h.nz = a.z;
      h.cr = c.x; h.cg = c.y; h.cb = c.z;
      h.er = c.w; h.eg = e.x; h.eb = e.y;
      h.mir = e.z;
      if constexpr (PRIMS) { h.inv_r = 0.f; h.sph = 0.f; }
      if constexpr (GLASS) h.ior = e.w;
      if constexpr (TEX)
        carry_tex<false>(h, tex + (size_t)(first + k) * TEX4, load4<STAGED>(R + 1),
                         load4<STAGED>(R + 2));
      own = true;
    } else if (tv == h.t && own && tv < BIG) {
      const float4 c = load4<STAGED>(R + 3);
      const float4 e = load4<STAGED>(R + 4);
      h.nx += a.x; h.ny += a.y; h.nz += a.z;
      h.cr += c.x; h.cg += c.y; h.cb += c.z;
      h.er += c.w; h.eg += e.x; h.eb += e.y;
      h.mir += e.z;
      if constexpr (GLASS) h.ior += e.w;
      if constexpr (TEX)
        carry_tex<true>(h, tex + (size_t)(first + k) * TEX4, load4<STAGED>(R + 1),
                        load4<STAGED>(R + 2));
    }
  }
}

// The same for `count` sphere records. `sdo` = D.O and `soo` = |O|^2 are
// the ray's share of the quadratic; FAR (glass spheres) takes the far root
// when the near one is not past t_min.
template <bool STAGED, bool FAR, bool GLASS, bool TEX>
__device__ __forceinline__ void scan_spheres(const float4* sph, const float4* tex, int first,
                                             int count,
                                             float ox, float oy, float oz, float dx,
                                             float dy, float dz, float sdo, float soo,
                                             float t_min, Hit& h, bool& own) {
  const float4* S = sph + (size_t)first * SPHERE4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < count; ++k, S += SPHERE4) {
    const float4 a = load4<STAGED>(S);  // centre, |c|^2 - r^2
    const float bq = sdo + -((a.x * dx + a.y * dy) + a.z * dz);
    const float q = soo + (a.w - 2.0f * ((a.x * ox + a.y * oy) + a.z * oz));
    const float disc = bq * bq - q;
    const float root = sqrtf(fmaxf(disc, 0.0f));
    float t = -bq - root;
    if (FAR) t = t > t_min ? t : -bq + root;
    const float tv = (disc > 0.0f && t > t_min) ? t : BIG;
    if (tv < h.t) {
      const float4 c = load4<STAGED>(S + 1);  // albedo, emission r
      const float4 e = load4<STAGED>(S + 2);  // emission g b, is_mirror, ior
      h.t = tv;
      h.nx = a.x; h.ny = a.y; h.nz = a.z;
      h.cr = c.x; h.cg = c.y; h.cb = c.z;
      h.er = c.w; h.eg = e.x; h.eb = e.y;
      h.mir = e.z;
      h.inv_r = load4<STAGED>(S + 3).x;
      h.sph = 1.0f;
      if constexpr (GLASS) h.ior = e.w;
      if constexpr (TEX) carry_tex<false>(h, tex + (size_t)(first + k) * TEX4, zero, zero);
      own = true;
    } else if (tv == h.t && own && tv < BIG) {
      const float4 c = load4<STAGED>(S + 1);
      const float4 e = load4<STAGED>(S + 2);
      h.nx += a.x; h.ny += a.y; h.nz += a.z;
      h.cr += c.x; h.cg += c.y; h.cb += c.z;
      h.er += c.w; h.eg += e.x; h.eb += e.y;
      h.mir += e.z;
      h.inv_r += load4<STAGED>(S + 3).x;
      h.sph += 1.0f;
      if constexpr (GLASS) h.ior += e.w;
      if constexpr (TEX) carry_tex<true>(h, tex + (size_t)(first + k) * TEX4, zero, zero);
    }
  }
}

// One tile, by its test mode.
template <bool STAGED, bool PRIMS, bool GLASS, bool TEX>
__device__ __forceinline__ void scan_tile(const float4* rec, const float4* sph,
                                          const float4* ptex, const float4* stex,
                                          const float* tile, float ox, float oy, float oz,
                                          float dx, float dy, float dz, float sdo,
                                          float soo, float t_min, Hit& h, bool& own) {
  const int first = (int)tile[6], count = (int)tile[7], mode = (int)tile[8];
  if (count == 0) return;
#define ROWS(MODE) \
  scan_rows<STAGED, MODE, PRIMS, GLASS, TEX>(rec, ptex, first, count, ox, oy, oz, dx, dy, dz, \
                                             t_min, h, own)
#define SPHERES(FAR) \
  scan_spheres<STAGED, FAR, GLASS, TEX>(sph, stex, first, count, ox, oy, oz, dx, dy, dz, sdo, \
                                        soo, t_min, h, own)
  if (mode == 0) ROWS(0);
  else if (mode == 1) ROWS(1);
  else if (mode == 2 || !(PRIMS || GLASS)) ROWS(2);
  else {
    if constexpr (PRIMS) {
      if (mode == 3) SPHERES(false);
      else if (mode == 4) ROWS(4);
    }
    if constexpr (GLASS) {
      if (mode == 6) ROWS(6);
    }
    if constexpr (PRIMS && GLASS) {
      if (mode == 5) SPHERES(true);
      else if (mode == 7) ROWS(7);
    }
  }
#undef ROWS
#undef SPHERES
}

// 1/x clamped to +-BIG: a zero direction component gives a huge, finite
// slab distance.
__device__ __forceinline__ float clamped_rcp(float x) {
  return fminf(fmaxf(1.0f / x, -BIG), BIG);
}

// STAGED: every group is single-tile and the records are in shared memory.
// PRIMS: the scene has triangles or spheres (modes 3, 4, 5, 7). GLASS: it
// has a glass group (modes 5, 6, 7) and the dielectric stage runs. TEX: it
// has a textured primitive and the texture stage runs. DIAG: the per-block
// diagnostics are gathered.
template <bool STAGED, bool SKY, bool PRIMS, bool GLASS, bool TEX, bool DIAG>
__global__ void trace_kernel(const Params p) {
  // Shared: [plane records, sphere records: STAGED only] [tile table] [walk order].
  extern __shared__ float4 shared[];
  const int n_staged = STAGED ? p.n_planes * RECORD4 + p.n_spheres * SPHERE4 : 0;
  float* s_tiles = (float*)(shared + n_staged);
  int* s_order = (int*)(s_tiles + p.n_tiles * TILE);
  const int n_walk = p.n_tiles - p.n_single;
  if (STAGED) {
    const float4* src = (const float4*)p.planes;
    for (int k = threadIdx.x; k < p.n_planes * RECORD4; k += blockDim.x) shared[k] = src[k];
    if constexpr (PRIMS) {
      const float4* ssrc = (const float4*)p.spheres;
      float4* dst = shared + p.n_planes * RECORD4;
      for (int k = threadIdx.x; k < p.n_spheres * SPHERE4; k += blockDim.x) dst[k] = ssrc[k];
    }
  }
  for (int k = threadIdx.x; k < p.n_tiles * TILE; k += blockDim.x) s_tiles[k] = p.tiles[k];
  for (int k = threadIdx.x; k < n_walk; k += blockDim.x) s_order[k] = p.order[k];
  __syncthreads();
  const float4* rec = STAGED ? shared : (const float4*)p.planes;
  const float4* sph = STAGED ? shared + p.n_planes * RECORD4 : (const float4*)p.spheres;
  const float4* ptex = (const float4*)p.plane_tex;
  const float4* stex = (const float4*)p.sphere_tex;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;

  // PCG init (_pcg_init): seed + pid * 2654435761 + r * 15823, then two
  // scramble rounds (the scramble's output becomes the state), then the
  // seed-row value in [0, 1) as a 24-bit integer, truncated toward zero.
  const uint32_t pid = (uint32_t)(i / p.block_rays);
  const uint32_t r = (uint32_t)(i % p.block_rays);
  uint32_t rng = (uint32_t)p.seed[0] + pid * 2654435761u + r * 15823u;
  for (int k = 0; k < 2; ++k) rng = pcg_scramble(rng);
  if (p.seed_row != nullptr) rng += (uint32_t)(int)(p.seed_row[i] * 16777216.0f);

  float ox = p.ori[3 * i], oy = p.ori[3 * i + 1], oz = p.ori[3 * i + 2];
  float dx = p.dirs[3 * i], dy = p.dirs[3 * i + 1], dz = p.dirs[3 * i + 2];
  const float t_min = p.t_min;
  float tr = 1.f, tg = 1.f, tb = 1.f;
  float lr = 0.f, lg = 0.f, lb = 0.f;
  int mh = 0, dc = 0;
  int lived = 0;  // segments entered alive (DIAG)

  for (int seg = 0; seg < p.max_segments; ++seg) {
    Hit h = {BIG, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (DIAG) ++lived;
    float sdo = 0.f, soo = 0.f;
    if constexpr (PRIMS) {
      sdo = (ox * dx + oy * dy) + oz * dz;
      soo = (ox * ox + oy * oy) + oz * oz;
    }
    // The single-tile groups are one joint scan: ties sum across them.
    bool own = true;
    for (int ti = 0; ti < p.n_single; ++ti)
      scan_tile<STAGED, PRIMS, GLASS, TEX>(rec, sph, ptex, stex, s_tiles + ti * TILE, ox, oy,
                                           oz, dx, dy, dz, sdo, soo, t_min, h, own);
    if constexpr (!STAGED) {
      const float idx = clamped_rcp(dx), idy = clamped_rcp(dy), idz = clamped_rcp(dz);
      for (int k = 0; k < n_walk; ++k) {
        const float* T = s_tiles + s_order[k] * TILE;
        const float t1x = (T[0] - ox) * idx, t2x = (T[3] - ox) * idx;
        const float t1y = (T[1] - oy) * idy, t2y = (T[4] - oy) * idy;
        const float t1z = (T[2] - oz) * idz, t2z = (T[5] - oz) * idz;
        float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        tn = tn - fabsf(tn) * 1e-3f;
        tf = tf + fabsf(tf) * 1e-3f;
        if (!((tf >= tn) && (tf > 0.f) && (tn < h.t))) continue;
        if constexpr (DIAG) {
          unsigned int* word = p.diag_mask +
              ((size_t)pid * p.max_segments + seg) * p.mask_words + (k >> 5);
          const unsigned int bit = 1u << (k & 31);
          if (!(*(volatile unsigned int*)word & bit)) atomicOr(word, bit);
        }
        own = false;
        scan_tile<false, PRIMS, GLASS, TEX>(rec, sph, ptex, stex, T, ox, oy, oz, dx, dy, dz, sdo,
                                            soo, t_min, h, own);
      }
    }

    const float t = h.t;
    const bool hit = t < BIG;
    if (!hit) {
      if constexpr (SKY) {
        // lighting_factor^(segment - mirror hits) * strength, with 0^0 = 1.
        const float expo = (float)(seg - mh);
        const float fac = p.sky_lf > 0.f ? expf(expo * p.sky_log_lf) * p.sky_strength
                                         : (expo == 0.f ? p.sky_strength : 0.f);
        lr = lr + p.sky_r * fac; lg = lg + p.sky_g * fac; lb = lb + p.sky_b * fac;
      }
      break;
    }
    float nx = h.nx, ny = h.ny, nz = h.nz;
    if constexpr (PRIMS) {
      // A sphere's normal, from the same o + d t as the position update.
      if (h.sph > 0.f) {
        nx = ((ox + dx * t) - nx) * h.inv_r;
        ny = ((oy + dy * t) - ny) * h.inv_r;
        nz = ((oz + dz * t) - nz) * h.inv_r;
      }
    }
    if constexpr (TEX) {
      // The checker: odd cells take the winner's second colour.
      const float hx = ox + dx * t, hy = oy + dy * t, hz = oz + dz * t;
      const float s1 = ((hx * h.w1x + hy * h.w1y) + hz * h.w1z) - h.b1;
      const float s2 = ((hx * h.w2x + hy * h.w2y) + hz * h.w2z) - h.b2;
      const float f1 = floorf(s1 * h.tsc) + floorf(s2 * h.tsc);
      const float f2 = (floorf(__fdiv_rn(hx, h.tsc)) + floorf(__fdiv_rn(hy, h.tsc))) +
                       floorf(__fdiv_rn(hz, h.tsc));
      const float f = h.tk > 1.5f ? f2 : f1;
      const bool odd = (f - 2.0f * floorf(f * 0.5f)) > 0.5f;
      if (h.tk > 0.f && odd) { h.cr = h.c2r; h.cg = h.c2g; h.cb = h.c2b; }
    }
    const float dn = (dx * nx + dy * ny) + dz * nz;
    const float side = dn > 0.f ? -1.f : (dn < 0.f ? 1.f : -dn);  // -sign(dn)
    bool glass = false;
    if constexpr (GLASS) glass = h.ior > 0.f;
    const bool mirror = (h.mir > 0.f) && (side != -1.f) && !glass;
    const bool diffuse = !mirror && !glass;
    const bool spec = mirror || glass;
    const int mh_new = mh + (spec ? 1 : 0);
    const bool mirror_live = mirror && (mh_new < p.mirror_limit);

    // One PCG word -> two 16-bit uniforms; (z, phi) unit vector.
    uint32_t word = pcg_scramble(rng);
    const float u1 = (float)(word & 0xFFFFu) * (1.0f / 65536.0f);
    const float u2 = (float)(word >> 16) * (1.0f / 65536.0f);
    const float z = u1 * 2.0f - 1.0f;
    const float x = u2 * 2.0f - 1.0f;
    const float k = rintf(x);
    const float sphi = sinpi_poly(x - k) * (1.0f - 2.0f * fabsf(k));
    const float cphi = sinpi_poly(0.5f - fabsf(x));
    const float rr = sqrtf(fmaxf(1.0f - z * z, 0.0f));
    const float ux = rr * cphi, uy = rr * sphi, uz = z;

    if (diffuse) {
      lr = lr + h.er * tr; lg = lg + h.eg * tg; lb = lb + h.eb * tb;
      tr = tr * h.cr; tg = tg * h.cg; tb = tb * h.cb;
    }
    if (mirror_live) {
      lr = lr + h.cr * p.mirror_tint;
      lg = lg + h.cg * p.mirror_tint;
      lb = lb + h.cb * p.mirror_tint;
    }
    float vx, vy, vz;
    if (diffuse) {
      vx = ux + nx * side; vy = uy + ny * side; vz = uz + nz * side;
    } else {
      vx = dx - 2.0f * dn * nx; vy = dy - 2.0f * dn * ny; vz = dz - 2.0f * dn * nz;
    }
    if constexpr (GLASS) {
      // The third uniform, drawn by every ray that hit anything.
      float u3 = 0.f;
      if (p.fresnel) u3 = (float)(pcg_scramble(rng) >> 8) * (1.0f / 16777216.0f);
      if (glass) {
        // Snell refraction on the unit direction, Schlick's reflectance.
        const float dinv = 1.0f / sqrtf((dx * dx + dy * dy) + dz * dz);
        const float dhx = dx * dinv, dhy = dy * dinv, dhz = dz * dinv;
        const float nex = nx * side, ney = ny * side, nez = nz * side;
        const float cos_i = fminf(fmaxf(-((dhx * nex + dhy * ney) + dhz * nez), 0.0f), 1.0f);
        const float eta = side > 0.f ? 1.0f / fmaxf(h.ior, 1e-6f) : h.ior;
        const float sin2t = eta * eta * (1.0f - cos_i * cos_i);
        const bool tir = sin2t > 1.0f;
        bool do_refl = tir;
        if (p.fresnel) {
          float r0 = (1.0f - eta) / (1.0f + eta);
          r0 = r0 * r0;
          const float pw = 1.0f - cos_i;
          const float p2 = pw * pw;
          const float reflect_p = tir ? 1.0f : r0 + (1.0f - r0) * (p2 * p2 * pw);
          do_refl = u3 < reflect_p;
        }
        const float coef = eta * cos_i - sqrtf(fmaxf(1.0f - sin2t, 0.0f));
        const float dnh = dn * dinv;
        if (do_refl) {
          vx = dhx - 2.0f * dnh * nx; vy = dhy - 2.0f * dnh * ny; vz = dhz - 2.0f * dnh * nz;
        } else {
          vx = eta * dhx + coef * nex; vy = eta * dhy + coef * ney; vz = eta * dhz + coef * nez;
        }
        if (mh_new < p.mirror_limit) {
          tr = tr * h.cr; tg = tg * h.cg; tb = tb * h.cb;
        }
      }
    }
    const float v_inv = 1.0f / sqrtf((vx * vx + vy * vy) + vz * vz);
    ox = ox + dx * t; oy = oy + dy * t; oz = oz + dz * t;
    dx = vx * v_inv; dy = vy * v_inv; dz = vz * v_inv;

    mh = mh_new;
    dc = dc + (diffuse ? 1 : 0);
    const bool alive = !(spec && mh_new >= p.mirror_limit) && dc < p.bounce_limit;
    if (!alive) break;
  }
  p.light[3 * i] = lr;
  p.light[3 * i + 1] = lg;
  p.light[3 * i + 2] = lb;
  if constexpr (DIAG) {
    const int n_blocks = (p.n_rays + p.block_rays - 1) / p.block_rays;
    atomicMax(p.diag_segments + pid, lived);
    atomicAdd(p.diag_segments + n_blocks + pid, lived);
  }
}

template <bool STAGED, bool SKY, bool PRIMS, bool GLASS>
static int launch(const Params& p, cudaStream_t stream) {
  constexpr bool TEX = MM_TEX, DIAG = MM_DIAG;
  if (TEX && ((p.n_planes > 0 && p.plane_tex == nullptr) ||
              (p.n_spheres > 0 && p.sphere_tex == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (DIAG && (p.diag_segments == nullptr || p.diag_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (p.n_rays + threads - 1) / threads;
  const size_t smem =
      (size_t)(STAGED ? p.n_planes * RECORD + p.n_spheres * SPHERE : 0) * sizeof(float) +
      (size_t)p.n_tiles * TILE * sizeof(float) +
      (size_t)(p.n_tiles - p.n_single) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(trace_kernel<STAGED, SKY, PRIMS, GLASS, TEX, DIAG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (p.n_rays > 0)
    trace_kernel<STAGED, SKY, PRIMS, GLASS, TEX, DIAG><<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool STAGED, bool SKY>
static int launch_stages(const Params& p, bool prims, bool glass, cudaStream_t s) {
  if (prims) return glass ? launch<STAGED, SKY, true, true>(p, s)
                          : launch<STAGED, SKY, true, false>(p, s);
  return glass ? launch<STAGED, SKY, false, true>(p, s)
               : launch<STAGED, SKY, false, false>(p, s);
}

extern "C" int mm_trace_paths(const float* ori, const float* dirs, const float* planes,
                              int n_planes, const float* spheres, int n_spheres,
                              const float* plane_tex, const float* sphere_tex,
                              const float* tiles, int n_tiles, int n_single,
                              const int* order, const int* seed, const float* seed_row,
                              float* light, int* diag_segments, unsigned int* diag_mask,
                              int mask_words, int n_rays, int block_rays, int max_segments,
                              int bounce_limit, int mirror_limit, int prims, int glass,
                              int fresnel, float mirror_tint, float t_min, float sky_r,
                              float sky_g, float sky_b, float sky_strength, float sky_lf,
                              float sky_log_lf, void* stream) {
  const Params p = {ori, dirs, planes, spheres, tiles, order, seed, seed_row, light,
                    n_planes, n_spheres, n_tiles, n_single,
                    n_rays, block_rays, max_segments, bounce_limit, mirror_limit, fresnel,
                    mirror_tint, t_min,
                    sky_r, sky_g, sky_b, sky_strength, sky_lf, sky_log_lf,
                    plane_tex, sphere_tex, diag_segments, diag_mask, mask_words};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool staged = n_tiles == n_single;
  const bool sky = sky_strength != 0.f;
  if (staged) return sky ? launch_stages<true, true>(p, prims, glass, s)
                         : launch_stages<true, false>(p, prims, glass, s);
  return sky ? launch_stages<false, true>(p, prims, glass, s)
             : launch_stages<false, false>(p, prims, glass, s);
}
