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
//   block of B rays (ray i belongs to block i / B, whichever warp traces
//   it), the most segments any of its rays lived (atomicMax) and their sum
//   (atomicAdd), and per block and segment one bit for every
//   walked tile that a live ray's slab test reached (atomicOr, tried only
//   while the bit reads as clear). The reference evaluates a tile for the
//   whole block when any live lane reaches it; the wrapper counts the bits.
//
// One source, four libraries: the macros MM_TEX and MM_DIAG (0 or 1, set on
// nvcc's command line) choose which of the two extra stages a translation
// unit instantiates, so a scene without textures traced without diagnostics
// runs none of their code.
//
// The order of work is free: a ray's light depends on its id alone (its PCG
// stream, its inputs), never on the rays beside it or on the launch
// geometry. The design for the card rests on that.
//
// Bound on the card: operations. Each (ray, plane) test costs ~16 f32
// operations plus 16 per tested edge and one IEEE reciprocal, a sphere test
// ~20 and a square root; memory traffic is the rays in and the light out.
// The kernel is built with -fmad=false (a contracted multiply-add would
// round differently from the reference), so every multiply and add issues
// on its own and the kernel can reach at most half of a bound that counts
// 67 TFLOP/s (a rate that counts a fused multiply-add as two). On the H100
// it is bound by instruction issue: the general test of a mode-1 record
// compiles to 57 instructions (its unrolled loop) for the 32 operations
// counted (the reciprocal's range check, compares, branches), the axis
// test below to 21.5 (mode 0: 92 and 29.5, mode 2: 15.5). What the design
// moves is how many instructions a record takes, how many lanes do useful
// work, how many records a warp tests that none of its rays needs, and
// where the records are read from:
//
// - Axis-aligned quads tested in two terms. A maze's walls, floors and
//   boundaries are quads whose normal and tested edges lie along the axes
//   (render/scenebuf.py axis_tables). For such a record the plane test
//   reduces, bit for bit, to t = (sign(n_A) d - o_A) (1 / d_A) and
//   s = (w_B o_B - b) + t (w_B d_B) (axis_min says why). Pass 1 tests a
//   scan's records in this form from 16- or 32-byte entries in shared
//   memory, sorted stably by axis class so that a run of one class picks
//   the ray's components once, and keeps the nearest t and its record (or
//   that records tie on it), a fold in any order (a min and two selects).
//   The ray's own lane then takes that record as the scan takes a nearer
//   one, or on a tie scans the whole scan again in record order, so ties
//   sum as they always did. Rays whose o or d has a non-finite component
//   and launches with t_min <= 0 take the general scan; a scene none of
//   whose scans holds 16 axis records (render/scenebuf.py
//   AXIS_MIN_RECORDS), or that has triangles or spheres, has no tables and
//   runs the instantiations without the route. The pass-1
//   tables stay resident where the whole scene does not fit beside them:
//   the records, which only the take and the rescans read, then come from
//   global memory.
//
// - Persistent warps that refill dead lanes. The grid fills the card (the
//   SM count times the resident blocks per SM, from the occupancy of each
//   instantiation) and no more. Each warp holds 32 rays; a lane whose ray
//   dies writes its light (and its diagnostics) and takes a new ray id. One
//   lane takes the ids for all of the warp's idle lanes with one atomicAdd
//   on a counter in global memory, and hands them out in lane order
//   (__ballot_sync / __popc / __shfl_sync), so fresh rays come in runs of
//   consecutive, Morton-coherent ids, after every segment in which a ray
//   died (against waiting for 16 idle lanes: within 2% where rays live
//   long, 5-13% faster where they die early). A warp without rays and with
//   the counter spent checks in at a second counter; the last one out sets
//   both back to 0, so the launch needs no reset of its own. The two
//   counters are the launch's `work` words, which the wrapper keeps one pair
//   of per device and stream: launches on one stream run in order, and
//   launches on two streams never share a pair.
// - The whole scene resident in shared memory whenever it fits: the plane
//   and sphere records, the texture rows, the tile table and the walk order
//   are copied once per block (plain 16-byte loads: the copy is once per
//   block of a persistent grid, so the TMA's bulk copy would save nothing
//   that shows), and the single-tile scan and the tile walk both read them
//   there, every lane of a warp the same record at once (a broadcast). The
//   launcher decides from the byte count (smem_bytes) against the
//   device's opt-in shared memory per block; a scene too large to fit keeps
//   its records in global memory, read through the read-only path, and
//   stages only the tile table and the walk order.
// - Walked tiles tested by the warp together where few lanes need them. A
//   warp of rays in different places reaches the union of its rays' tiles
//   (on the mesh gallery 2.4 of 3 tiles a warp-segment where one ray needs
//   0.6), and one thread a ray pays for every tile of that union in every
//   lane. So all lanes walk the tiles together, and a tile that few of them
//   reach is tested ray by ray by the whole warp: each lane takes every 32nd
//   record, folded as pass 1 folds (the nearest t and its record, or that
//   records tie on it), and the ray's own lane then takes that record (on a
//   tie, the whole tile in record order) through the same scan as before,
//   so the result is the sequential scan's bit for bit. A tile that many lanes
//   reach is scanned by each of them alone, as before.
// - The diagnostics are aggregated per warp: the lanes that finish a ray of
//   the same reference block in the same step are grouped with
//   __match_any_sync and one of them makes the block's two atomics.
// - Every instantiation counts its work into the launch's `counters`
//   (Count, below: one buffer of 64-bit words per device, added to by every
//   launch and never reset by one). Lane 0 of a warp adds to the warp's slot
//   in shared memory at points where the warp is converged, so the counts
//   hold no register across the loop, and the warp adds its slot to the
//   buffer with one atomicAdd a word when it checks in.
//
// The stages a scene does not need are template parameters (PRIMS:
// triangles or spheres; GLASS; WALK: multi-tile groups), so a maze of opaque
// quads in one tile compiles none of them.

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
#define FULL 0xffffffffu
#define WARPS 32   // most warps of a block (1,024 threads)
#define AXIS_GENERAL 27  // class of the pass-1 entries tested in the general form
// The per-ray cost of the warp's test of an axis tile for one ray (its
// shuffles, reductions and runs), in halves of an axis record's test: about
// twelve records. Measured on config_scale's tracer (H100): 24 against 4,
// 10, 16, 48 and never, 0.5-9% faster.
#define AXIS_RAY_COST 24

// The launch's counters (render/fused_tracer.py COUNTERS, in this order).
// A record test is one plane or sphere record tested for one ray.
enum Count {
  RAY_SEGMENTS,   // (ray, segment) pairs traced alive
  WARP_SEGMENTS,  // (warp, segment) pairs with a live lane
  TESTS_ISSUED,   // record tests issued in lane slots, needed or not
  TESTS_NEEDED,   // record tests the live rays that reach a tile need
  AXIS_TESTS,     // of TESTS_ISSUED, the axis records' two-term tests (pass 1)
  COUNTS
};

// Per warp: its counts so far, the single-tile groups' tests left out (they
// follow from the segments at the check-in). Only the warp's lane 0 reads
// and writes its slot.
__shared__ unsigned long long warp_counts[WARPS][COUNTS];
constexpr size_t COUNT_BYTES = sizeof(unsigned long long) * WARPS * COUNTS;

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
  unsigned int* work;     // [2]: the next ray id to hand out, the warps checked in
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
  unsigned long long* counters;  // [COUNTS], added to (Count)
  // The pass-1 tables (AXIS kernels; render/scenebuf.py axis_tables).
  const float* axis_entries;  // [n_axis4, 4] pass-1 entries
  const int* axis_tiles;      // [n_tiles, 4] first run, runs, axis records, their lane slots
  const int* axis_runs;       // [n_runs, 4] first float4, entries, class, axes
  int n_axis4, n_runs;
};

// The running nearest hit: t and the winner's (tie-summed) normal (a
// sphere's centre), albedo, emission and is_mirror; 1/r and the is-sphere
// flag (PRIMS kernels), the ior (GLASS kernels), and the texture row with
// the plane's w1, b1, w2, b2 (TEX kernels; zeros for a sphere).
struct Hit {
  float t, nx, ny, nz, cr, cg, cb, er, eg, eb, mir, inv_r, sph, ior;
  float tk, tsc, c2r, c2g, c2b, w1x, w1y, w1z, b1, w2x, w2y, w2z, b2;
};

template <bool RESIDENT>
__device__ __forceinline__ float4 load4(const float4* p) {
  if constexpr (RESIDENT) return *p;
  else return __ldg(p);
}

// The winner's texture row and edge constants: set when a primitive wins,
// added when it ties. `tex` is the primitive's row of the texture table,
// `w1`/`w2` its (w, b) float4s, zeros for a sphere.
template <bool RESIDENT, bool ADD>
__device__ __forceinline__ void carry_tex(Hit& h, const float4* tex, float4 w1, float4 w2) {
  const float4 a = load4<RESIDENT>(tex), b = load4<RESIDENT>(tex + 1);  // kind, scale, colour2
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

// The hit distance of one plane record of a mode (BIG on a miss); `a` gets
// the record's first float4 (normal, d).
template <bool RESIDENT, int MODE>
__device__ __forceinline__ float row_t(const float4* R, float ox, float oy, float oz, float dx,
                                       float dy, float dz, float t_min, float4& a) {
  constexpr bool TRIANGLE = MODE == 4 || MODE == 7;
  constexpr bool EDGE1 = MODE == 0 || MODE == 1 || MODE == 6;
  constexpr bool EDGE2 = MODE == 0 || MODE == 6;
  a = load4<RESIDENT>(R);
  const float numer = a.w - ((a.x * ox + a.y * oy) + a.z * oz);
  const float denom = (a.x * dx + a.y * dy) + a.z * dz;
  const float t = numer * (1.0f / denom);
  bool ok = t > t_min;
  if (EDGE1 || TRIANGLE) {
    const float4 b = load4<RESIDENT>(R + 1);  // w1, b1
    const float s1 = (((b.x * ox + b.y * oy) + b.z * oz) - b.w) +
                     t * ((b.x * dx + b.y * dy) + b.z * dz);
    if (EDGE1) ok = ok && (s1 >= 0.f) && (1.0f - s1 >= 0.f);
    if (EDGE2 || TRIANGLE) {
      const float4 c = load4<RESIDENT>(R + 2);  // w2, b2
      const float s2 = (((c.x * ox + c.y * oy) + c.z * oz) - c.w) +
                       t * ((c.x * dx + c.y * dy) + c.z * dz);
      if (EDGE2) ok = ok && (s2 >= 0.f) && (1.0f - s2 >= 0.f);
      if (TRIANGLE) ok = ok && (s1 >= 0.f) && (s2 >= 0.f) && (1.0f - (s1 + s2) >= 0.f);
    }
  }
  return ok ? t : BIG;
}

// The hit distance of one sphere record (BIG on a miss). `sdo` = D.O and
// `soo` = |O|^2 are the ray's share of the quadratic; FAR (glass spheres)
// takes the far root when the near one is not past t_min. `a` gets the
// record's first float4 (centre, |c|^2 - r^2).
template <bool RESIDENT, bool FAR>
__device__ __forceinline__ float sphere_t(const float4* S, float ox, float oy, float oz,
                                          float dx, float dy, float dz, float sdo, float soo,
                                          float t_min, float4& a) {
  a = load4<RESIDENT>(S);
  const float bq = sdo + -((a.x * dx + a.y * dy) + a.z * dz);
  const float q = soo + (a.w - 2.0f * ((a.x * ox + a.y * oy) + a.z * oz));
  const float disc = bq * bq - q;
  const float root = sqrtf(fmaxf(disc, 0.0f));
  float t = -bq - root;
  if (FAR) t = t > t_min ? t : -bq + root;
  return (disc > 0.0f && t > t_min) ? t : BIG;
}

// Make plane record R (its first float4 `a`, texture row `tex`) the running
// hit at distance `t`: what a scan does where a record is strictly nearer.
template <bool RESIDENT, bool PRIMS, bool GLASS, bool TEX>
__device__ __forceinline__ void take_row(const float4* R, float4 a, const float4* tex, float t,
                                         Hit& h, bool& own) {
  const float4 c = load4<RESIDENT>(R + 3);  // albedo, emission r
  const float4 e = load4<RESIDENT>(R + 4);  // emission g b, is_mirror, ior
  h.t = t;
  h.nx = a.x; h.ny = a.y; h.nz = a.z;
  h.cr = c.x; h.cg = c.y; h.cb = c.z;
  h.er = c.w; h.eg = e.x; h.eb = e.y;
  h.mir = e.z;
  if constexpr (PRIMS) { h.inv_r = 0.f; h.sph = 0.f; }
  if constexpr (GLASS) h.ior = e.w;
  if constexpr (TEX)
    carry_tex<RESIDENT, false>(h, tex, load4<RESIDENT>(R + 1), load4<RESIDENT>(R + 2));
  own = true;
}

// Test `count` plane records of one mode from row `first` on against the
// ray and fold them into the running hit.
template <bool RESIDENT, int MODE, bool PRIMS, bool GLASS, bool TEX>
__device__ __forceinline__ void scan_rows(const float4* rec, const float4* tex, int first,
                                          int count,
                                          float ox, float oy, float oz, float dx,
                                          float dy, float dz, float t_min, Hit& h,
                                          bool& own) {
  const float4* R = rec + (size_t)first * RECORD4;
  for (int k = 0; k < count; ++k, R += RECORD4) {
    float4 a;
    const float tv = row_t<RESIDENT, MODE>(R, ox, oy, oz, dx, dy, dz, t_min, a);
    if (tv < h.t) {
      take_row<RESIDENT, PRIMS, GLASS, TEX>(R, a, tex + (size_t)(first + k) * TEX4, tv, h, own);
    } else if (tv == h.t && own && tv < BIG) {
      const float4 c = load4<RESIDENT>(R + 3);
      const float4 e = load4<RESIDENT>(R + 4);
      h.nx += a.x; h.ny += a.y; h.nz += a.z;
      h.cr += c.x; h.cg += c.y; h.cb += c.z;
      h.er += c.w; h.eg += e.x; h.eb += e.y;
      h.mir += e.z;
      if constexpr (GLASS) h.ior += e.w;
      if constexpr (TEX)
        carry_tex<RESIDENT, true>(h, tex + (size_t)(first + k) * TEX4, load4<RESIDENT>(R + 1),
                                  load4<RESIDENT>(R + 2));
    }
  }
}

// The same for `count` sphere records.
template <bool RESIDENT, bool FAR, bool GLASS, bool TEX>
__device__ __forceinline__ void scan_spheres(const float4* sph, const float4* tex, int first,
                                             int count,
                                             float ox, float oy, float oz, float dx,
                                             float dy, float dz, float sdo, float soo,
                                             float t_min, Hit& h, bool& own) {
  const float4* S = sph + (size_t)first * SPHERE4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < count; ++k, S += SPHERE4) {
    float4 a;
    const float tv = sphere_t<RESIDENT, FAR>(S, ox, oy, oz, dx, dy, dz, sdo, soo, t_min, a);
    if (tv < h.t) {
      const float4 c = load4<RESIDENT>(S + 1);  // albedo, emission r
      const float4 e = load4<RESIDENT>(S + 2);  // emission g b, is_mirror, ior
      h.t = tv;
      h.nx = a.x; h.ny = a.y; h.nz = a.z;
      h.cr = c.x; h.cg = c.y; h.cb = c.z;
      h.er = c.w; h.eg = e.x; h.eb = e.y;
      h.mir = e.z;
      h.inv_r = load4<RESIDENT>(S + 3).x;
      h.sph = 1.0f;
      if constexpr (GLASS) h.ior = e.w;
      if constexpr (TEX)
        carry_tex<RESIDENT, false>(h, tex + (size_t)(first + k) * TEX4, zero, zero);
      own = true;
    } else if (tv == h.t && own && tv < BIG) {
      const float4 c = load4<RESIDENT>(S + 1);
      const float4 e = load4<RESIDENT>(S + 2);
      h.nx += a.x; h.ny += a.y; h.nz += a.z;
      h.cr += c.x; h.cg += c.y; h.cb += c.z;
      h.er += c.w; h.eg += e.x; h.eb += e.y;
      h.mir += e.z;
      h.inv_r += load4<RESIDENT>(S + 3).x;
      h.sph += 1.0f;
      if constexpr (GLASS) h.ior += e.w;
      if constexpr (TEX)
        carry_tex<RESIDENT, true>(h, tex + (size_t)(first + k) * TEX4, zero, zero);
    }
  }
}

// `count` records of one test mode from `first` on (a tile: its row's
// columns 6-8, or a part of one), by the mode.
template <bool RESIDENT, bool PRIMS, bool GLASS, bool TEX>
__device__ __forceinline__ void scan_group(const float4* rec, const float4* sph,
                                           const float4* ptex, const float4* stex, int first,
                                           int count, int mode, float ox, float oy, float oz,
                                           float dx, float dy, float dz, float sdo,
                                           float soo, float t_min, Hit& h, bool& own) {
  if (count == 0) return;
#define ROWS(MODE) \
  scan_rows<RESIDENT, MODE, PRIMS, GLASS, TEX>(rec, ptex, first, count, ox, oy, oz, dx, dy, \
                                               dz, t_min, h, own)
#define SPHERES(FAR) \
  scan_spheres<RESIDENT, FAR, GLASS, TEX>(sph, stex, first, count, ox, oy, oz, dx, dy, dz, \
                                          sdo, soo, t_min, h, own)
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

// Fold record `k`'s hit distance `tv` (+inf on a miss, which neither beats
// nor ties anything) into a lane's pass 1: the nearest t (`lm`) and the
// record at it (`li`), or TIED where two records or more are at it. Any
// order of records gives the same two: two selects and a min.
#define TIED -1
__device__ __forceinline__ void fold_min(float tv, int k, float& lm, int& li) {
  li = tv < lm ? k : (tv == lm ? TIED : li);
  lm = fminf(lm, tv);
}

__device__ __forceinline__ float pick3(int axis, float x, float y, float z) {
  return axis == 0 ? x : (axis == 1 ? y : z);
}

// Pass 1 of an axis tile of mode MODE: its runs [r0, r0 + nr) of pass-1
// entries (`ent`, shared memory), this lane taking entries start, start +
// step, ... of each run. An entry's index counts from `base`, the place of
// the tile's first record in its scan (the single-tile groups' joint one,
// or the walked tile's own). An axis record's test, for a ray with finite o
// and d and t_min > 0:
//
//   t = (sign(n_A) d - o_A) * (1 / d_A), s = (w_B o_B - b) + t (w_B d_B)
//
// where the general test (row_t) computes t = (d - n.o) * (1 / n.d) and s =
// (w.o - b) + t (w.d). With one nonzero component of n, w and n_A = +-1,
// every other product is a zero, the dots are n_A o_A, n_A d_A, w_B o_B and
// w_B d_B exactly (up to the sign of a zero), 1 / (n_A d_A) = n_A (1 / d_A)
// and (d - n_A o_A) n_A = sign(n_A) d - o_A, since rounding is symmetric in
// sign: the same t and s. They differ only where a record has no effect in
// either: a zero's sign reaches t = +-0, which fails t > t_min, or an s that
// is compared with 0 and 1, where -0 and +0 agree; d_A = +-0 gives t = +-inf
// or NaN, which fails t > t_min or an edge test, or (mode 2) is no nearer
// than the running hit (at most BIG). And 1 - s >= 0 is s <= 1 for every
// float s. A record of the run of class AXIS_GENERAL takes the general test.
template <bool RESIDENT, int MODE>
__device__ __forceinline__ void axis_min(const float4* ent, const int4* runs, int r0, int nr,
                                         const float4* rec, int first, int base, int start,
                                         int step, float ox, float oy, float oz, float dx,
                                         float dy, float dz, float ix, float iy, float iz,
                                         float t_min, float& lm, int& li) {
  constexpr int W = (MODE == 0 || MODE == 6) ? 2 : 1;   // float4s an entry
  constexpr bool EDGE1 = MODE != 2;
  constexpr bool EDGE2 = MODE == 0 || MODE == 6;
  const float inf = __int_as_float(0x7f800000);
  for (int r = r0; r < r0 + nr; ++r) {
    const int4 run = runs[r];   // first float4, entries, class, its axes A | B << 8 | C << 16
    const float4* E = ent + run.x;
    if (run.z == AXIS_GENERAL) {
      for (int e = start; e < run.y; e += step) {
        const int k = __float_as_int(E[e * W].w);
        float4 a;
        const float tv = row_t<RESIDENT, MODE>(rec + (size_t)(first + k - base) * RECORD4, ox,
                                               oy, oz, dx, dy, dz, t_min, a);
        fold_min(tv < BIG ? tv : inf, k, lm, li);
      }
      continue;
    }
    const int A = run.w & 3, B = (run.w >> 8) & 3, C = run.w >> 16;
    const float oa = pick3(A, ox, oy, oz), ia = pick3(A, ix, iy, iz);
    const float ob = pick3(B, ox, oy, oz), db = pick3(B, dx, dy, dz);
    const float oc = pick3(C, ox, oy, oz), dc = pick3(C, dx, dy, dz);
    for (int e = start; e < run.y; e += step) {
      const float4 x = E[e * W];   // sign(n_A) d, w1_B, b1, index
      const float t = (x.x - oa) * ia;
      bool ok = t > t_min;
      if (EDGE1) {
        const float s1 = (x.y * ob - x.z) + t * (x.y * db);
        ok = ok && s1 >= 0.f && s1 <= 1.f;
      }
      if (EDGE2) {
        const float4 y = E[e * W + 1];   // w2_C, b2
        const float s2 = (y.x * oc - y.y) + t * (y.x * dc);
        ok = ok && s2 >= 0.f && s2 <= 1.f;
      }
      fold_min(ok ? t : inf, __float_as_int(x.w), lm, li);
    }
  }
}

template <bool RESIDENT, bool GLASS>
__device__ __forceinline__ void tile_axis_min(const float4* ent, const int4* runs, int4 ax,
                                              const float4* rec, int first, int base, int mode,
                                              int start, int step, float ox, float oy,
                                              float oz, float dx, float dy, float dz,
                                              float ix, float iy, float iz, float t_min,
                                              float& lm, int& li) {
#define AXIS_MIN(MODE) \
  axis_min<RESIDENT, MODE>(ent, runs, ax.x, ax.y, rec, first, base, start, step, ox, oy, oz, \
                           dx, dy, dz, ix, iy, iz, t_min, lm, li)
  if (mode == 0) AXIS_MIN(0);
  else if (mode == 1) AXIS_MIN(1);
  else if (mode == 2 || !GLASS) AXIS_MIN(2);
  else AXIS_MIN(6);
#undef AXIS_MIN
}

// The general test's pass 1 of records start, start + step, ... of the
// `count` from `first` on, indices counted from `base`.
template <bool RESIDENT, bool SPHERES, int MODE>
__device__ __forceinline__ void general_min(const float4* base_rec, int first, int count,
                                            int base, int start, int step, float ox, float oy,
                                            float oz, float dx, float dy, float dz, float sdo,
                                            float soo, float t_min, float& lm, int& li) {
  const float inf = __int_as_float(0x7f800000);
  for (int r = start; r < count; r += step) {
    float4 a;
    float tv;
    if constexpr (SPHERES)
      tv = sphere_t<RESIDENT, MODE == 5>(base_rec + (size_t)(first + r) * SPHERE4, ox, oy, oz,
                                         dx, dy, dz, sdo, soo, t_min, a);
    else
      tv = row_t<RESIDENT, MODE>(base_rec + (size_t)(first + r) * RECORD4, ox, oy, oz, dx, dy,
                                 dz, t_min, a);
    fold_min(tv < BIG ? tv : inf, base + r, lm, li);
  }
}

template <bool RESIDENT, bool PRIMS, bool GLASS>
__device__ __forceinline__ void tile_general_min(const float4* rec, const float4* sph,
                                                 int first, int count, int base, int mode,
                                                 int start, int step, float ox, float oy,
                                                 float oz, float dx, float dy, float dz,
                                                 float sdo, float soo, float t_min, float& lm,
                                                 int& li) {
#define GENERAL_MIN(B, SPH, MODE) \
  general_min<RESIDENT, SPH, MODE>(B, first, count, base, start, step, ox, oy, oz, dx, dy, dz, \
                                   sdo, soo, t_min, lm, li)
  if (mode == 0) GENERAL_MIN(rec, false, 0);
  else if (mode == 1) GENERAL_MIN(rec, false, 1);
  else if (mode == 2 || !(PRIMS || GLASS)) GENERAL_MIN(rec, false, 2);
  else {
    if constexpr (PRIMS) {
      if (mode == 3) GENERAL_MIN(sph, true, 3);
      else if (mode == 4) GENERAL_MIN(rec, false, 4);
    }
    if constexpr (GLASS) {
      if (mode == 6) GENERAL_MIN(rec, false, 6);
    }
    if constexpr (PRIMS && GLASS) {
      if (mode == 5) GENERAL_MIN(sph, true, 5);
      else if (mode == 7) GENERAL_MIN(rec, false, 7);
    }
  }
#undef GENERAL_MIN
}

// Whether all six of a ray's components are finite (the axis test's guard).
__device__ __forceinline__ bool finite_ray(float ox, float oy, float oz, float dx, float dy,
                                           float dz) {
  const float inf = __int_as_float(0x7f800000);
  return fabsf(ox) < inf && fabsf(oy) < inf && fabsf(oz) < inf && fabsf(dx) < inf &&
         fabsf(dy) < inf && fabsf(dz) < inf;
}

// 1/x clamped to +-BIG: a zero direction component gives a huge, finite
// slab distance.
__device__ __forceinline__ float clamped_rcp(float x) {
  return fminf(fmaxf(1.0f / x, -BIG), BIG);
}

// Copy n float4s from global to shared memory, the block's threads together.
__device__ __forceinline__ void stage(float4* dst, const float* src, int n) {
  const float4* s = (const float4*)src;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = s[k];
}

// Float4s of shared memory the records (and texture rows) of a resident
// scene take, ahead of the tile table.
__host__ __device__ __forceinline__ int resident_float4s(const Params& p, bool tex) {
  return p.n_planes * RECORD4 + p.n_spheres * SPHERE4 +
         (tex ? (p.n_planes + p.n_spheres) * TEX4 : 0);
}

// Float4s of shared memory the pass-1 tables take (AXIS kernels), after the
// resident records: the entries, a row of 4 ints a tile, 4 ints a run.
__host__ __device__ __forceinline__ int axis_float4s(const Params& p) {
  return p.n_axis4 + p.n_tiles + p.n_runs;
}

// Bytes of dynamic shared memory a block stages: the resident records
// (RESIDENT only), the pass-1 tables (AXIS only), the tile table and the
// walk order. The warps' counts (warp_counts) take COUNT_BYTES more,
// statically.
static size_t smem_bytes(const Params& p, bool resident, bool tex, bool axis) {
  return (size_t)((resident ? resident_float4s(p, tex) : 0) + (axis ? axis_float4s(p) : 0)) *
             sizeof(float4) +
         (size_t)p.n_tiles * TILE * sizeof(float) +
         (size_t)(p.n_tiles - p.n_single) * sizeof(int);
}

// RESIDENT: the records (and texture rows) are in shared memory. WALK: the
// scene has multi-tile groups, walked tile by tile (a global-memory scene
// always takes the walk, which runs no tile where there is none). PRIMS:
// the scene has triangles or spheres (modes 3, 4, 5, 7). GLASS: it has a
// glass group (modes 5, 6, 7) and the dielectric stage runs. TEX: it has a
// textured primitive and the texture stage runs. DIAG: the per-block
// diagnostics are gathered. AXIS (never with PRIMS): the scene has axis
// records, their pass-1 tables are in shared memory, t_min > 0, and the
// tiles that hold axis records take the axis route (pass 1, then the winner
// taken, or on a tie the scan again in record order); the others, and every
// lane whose o or d has a non-finite component, keep the general scan.
//
// The libraries without the texture stage hold their kernels to blocks of
// 1,024 threads, so to 64 registers: a walking kernel (78-92 registers
// otherwise) then runs 32 warps on an SM beside a whole 64x64 maze, at the
// cost of 120-240 bytes of spills a thread; the others use fewer than 64
// anyway. A walking kernel of the axis route is held to 768 threads, so to
// 80 registers: at 64 it spills 270 + 320 bytes a thread, and its 24 warps
// an SM run config_scale's tracer 3% faster than 32 (H100). The textured
// kernels (72-112 registers) keep what they use.
#if MM_TEX
#define TRACE_BOUNDS(THREADS)
#else
#define TRACE_BOUNDS(THREADS) __launch_bounds__(THREADS)
#endif
template <bool RESIDENT, bool WALK, bool SKY, bool PRIMS, bool GLASS, bool TEX, bool DIAG,
          bool AXIS>
__global__ void TRACE_BOUNDS(AXIS && WALK ? 768 : 1024) trace_kernel(const Params p) {
  // Shared: [plane records, sphere records, texture rows: RESIDENT only]
  // [pass-1 entries, axis tile rows, runs: AXIS only] [tile table] [walk order].
  extern __shared__ float4 shared[];
  const int n_res = (RESIDENT ? resident_float4s(p, TEX) : 0) + (AXIS ? axis_float4s(p) : 0);
  float* s_tiles = (float*)(shared + n_res);
  int* s_order = (int*)(s_tiles + p.n_tiles * TILE);
  const int n_walk = p.n_tiles - p.n_single;
  const float4* rec = (const float4*)p.planes;
  const float4* sph = (const float4*)p.spheres;
  const float4* ptex = (const float4*)p.plane_tex;
  const float4* stex = (const float4*)p.sphere_tex;
  if constexpr (RESIDENT) {
    float4* at = shared;
    stage(at, p.planes, p.n_planes * RECORD4);
    rec = at;
    at += p.n_planes * RECORD4;
    stage(at, p.spheres, p.n_spheres * SPHERE4);
    sph = at;
    at += p.n_spheres * SPHERE4;
    if constexpr (TEX) {
      stage(at, p.plane_tex, p.n_planes * TEX4);
      ptex = at;
      at += p.n_planes * TEX4;
      stage(at, p.sphere_tex, p.n_spheres * TEX4);
      stex = at;
    }
  }
  const float4* ent = nullptr;   // AXIS: the pass-1 entries, tile rows and runs
  const int4* s_axt = nullptr;
  const int4* s_runs = nullptr;
  if constexpr (AXIS) {
    float4* at = shared + (RESIDENT ? resident_float4s(p, TEX) : 0);
    stage(at, p.axis_entries, p.n_axis4);
    ent = at;
    at += p.n_axis4;
    stage(at, (const float*)p.axis_tiles, p.n_tiles);
    s_axt = (const int4*)at;
    at += p.n_tiles;
    stage(at, (const float*)p.axis_runs, p.n_runs);
    s_runs = (const int4*)at;
  }
  for (int k = threadIdx.x; k < p.n_tiles * TILE; k += blockDim.x) s_tiles[k] = p.tiles[k];
  for (int k = threadIdx.x; k < n_walk; k += blockDim.x) s_order[k] = p.order[k];
  __syncthreads();

  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  if (lane == 0)
    for (int c = 0; c < COUNTS; ++c) warp_counts[threadIdx.x >> 5][c] = 0;
  const uint32_t seed = (uint32_t)p.seed[0];
  const float t_min = p.t_min;
  // AXIS: the single-tile groups' records, and of them the axis records.
  int single_all = 0, single_axis = 0;
  if constexpr (AXIS) {
    for (int ti = 0; ti < p.n_single; ++ti) {
      single_all += (int)s_tiles[ti * TILE + 7];
      single_axis += s_axt[ti].z;
    }
  }
  bool more = true;   // the counter may still hold rays (the same in all lanes)
  // This lane's ray (-1: none) and its state.
  int i = -1, seg = 0, mh = 0, dc = 0;
  uint32_t rng = 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tr = 1.f, tg = 1.f, tb = 1.f, lr = 0.f, lg = 0.f, lb = 0.f;

  while (true) {
    // Refill: one atomicAdd for all idle lanes, ids handed out in lane order.
    const unsigned idle = __ballot_sync(FULL, i < 0);
    if (more && idle != 0) {
      const unsigned want = __popc(idle);
      unsigned base = 0;
      if (lane == 0) base = atomicAdd(p.work, want);
      base = __shfl_sync(FULL, base, 0);
      more = base + want < (unsigned)p.n_rays;
      const unsigned id = base + __popc(idle & below);
      if (i < 0 && id < (unsigned)p.n_rays) {
        i = (int)id;
        // PCG init (_pcg_init): seed + pid * 2654435761 + r * 15823, then
        // two scramble rounds (the scramble's output becomes the state),
        // then the seed-row value in [0, 1) as a 24-bit integer, truncated
        // toward zero.
        const uint32_t pid = id / (unsigned)p.block_rays;
        const uint32_t r = id - pid * (unsigned)p.block_rays;
        rng = seed + pid * 2654435761u + r * 15823u;
        for (int k = 0; k < 2; ++k) rng = pcg_scramble(rng);
        if (p.seed_row != nullptr) rng += (uint32_t)(int)(p.seed_row[i] * 16777216.0f);
        ox = p.ori[3 * i]; oy = p.ori[3 * i + 1]; oz = p.ori[3 * i + 2];
        dx = p.dirs[3 * i]; dy = p.dirs[3 * i + 1]; dz = p.dirs[3 * i + 2];
        tr = tg = tb = 1.f;
        lr = lg = lb = 0.f;
        mh = dc = seg = 0;
      }
    }
    const unsigned live = __ballot_sync(FULL, i >= 0);
    if (live == 0) {
      if (!more) break;
      continue;
    }
    if (lane == 0) {
      warp_counts[threadIdx.x >> 5][RAY_SEGMENTS] += __popc(live);
      warp_counts[threadIdx.x >> 5][WARP_SEGMENTS] += 1;
    }
    bool dead = false;
    const bool active = i >= 0;
    // One segment of each lane's ray.
    Hit h = {BIG, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float sdo = 0.f, soo = 0.f;
    bool own = true;
    // AXIS: whether the lane's ray takes the axis route (o and d finite), and
    // its IEEE reciprocals of d.
    bool fin = false;
    float ix = 0.f, iy = 0.f, iz = 0.f;
    int rescan = 0;   // AXIS: the records this lane rescans of the single-tile groups
    if (active) {
      if constexpr (PRIMS) {
        sdo = (ox * dx + oy * dy) + oz * dz;
        soo = (ox * ox + oy * oy) + oz * oz;
      }
      if constexpr (AXIS) {
        fin = finite_ray(ox, oy, oz, dx, dy, dz);
        ix = 1.0f / dx;
        iy = 1.0f / dy;
        iz = 1.0f / dz;
      }
      if (AXIS && fin && single_axis > 0) {
        // The single-tile groups are one joint scan (ties sum across them):
        // pass 1 over all their records, indexed in that scan, then the
        // record at the nearest t, or where records tie on it, the whole
        // scan again in record order.
        float lm = BIG;
        int li = 0;
        for (int ti = 0, off = 0; ti < p.n_single; ++ti) {
          const float* T = s_tiles + ti * TILE;
          const int first = (int)T[6], count = (int)T[7], mode = (int)T[8];
          const int4 ax = s_axt[ti];
          if (ax.y > 0)
            tile_axis_min<RESIDENT, GLASS>(ent, s_runs, ax, rec, first, off, mode, 0, 1, ox, oy,
                                           oz, dx, dy, dz, ix, iy, iz, t_min, lm, li);
          else
            tile_general_min<RESIDENT, PRIMS, GLASS>(rec, sph, first, count, off, mode, 0, 1,
                                                     ox, oy, oz, dx, dy, dz, sdo, soo, t_min,
                                                     lm, li);
          off += count;
        }
        if (lm < BIG && li == TIED) {
          // Records tie on the nearest t: the whole joint scan again.
          rescan = single_all;
          for (int ti = 0; ti < p.n_single; ++ti) {
            const float* T = s_tiles + ti * TILE;
            scan_group<RESIDENT, PRIMS, GLASS, TEX>(rec, sph, ptex, stex, (int)T[6], (int)T[7],
                                                    (int)T[8], ox, oy, oz, dx, dy, dz, sdo, soo,
                                                    t_min, h, own);
          }
        } else if (lm < BIG) {
          // The record at it, taken as the scan takes a nearer record.
          int ti = 0, off = 0;
          for (; li >= off + (int)s_tiles[ti * TILE + 7]; ++ti) off += (int)s_tiles[ti * TILE + 7];
          const int k = (int)s_tiles[ti * TILE + 6] + li - off;
          const float4* R = rec + (size_t)k * RECORD4;
          take_row<RESIDENT, PRIMS, GLASS, TEX>(R, load4<RESIDENT>(R), ptex + (size_t)k * TEX4,
                                                lm, h, own);
        }
      } else {
        // The single-tile groups are one joint scan: ties sum across them.
        for (int ti = 0; ti < p.n_single; ++ti) {
          const float* T = s_tiles + ti * TILE;
          scan_group<RESIDENT, PRIMS, GLASS, TEX>(rec, sph, ptex, stex, (int)T[6], (int)T[7],
                                                  (int)T[8], ox, oy, oz, dx, dy, dz, sdo, soo,
                                                  t_min, h, own);
        }
      }
    }
    if constexpr (AXIS) {
      // The lane slots of the single-tile groups: pass 1 where a lane took
      // the axis route, the general scan where one did not, and the longest
      // rescan.
      __syncwarp();
      const bool axis_route = fin && single_axis > 0;
      const unsigned fm = __ballot_sync(FULL, axis_route);
      const unsigned gm = __ballot_sync(FULL, active && !axis_route);
      const int longest = __reduce_max_sync(FULL, rescan);
      if (lane == 0) {
        unsigned long long* c = warp_counts[threadIdx.x >> 5];
        c[TESTS_ISSUED] += 32ull * ((unsigned long long)single_all * ((fm != 0) + (gm != 0)) +
                                    (unsigned)longest);
        if (fm != 0) c[AXIS_TESTS] += 32ull * single_axis;
      }
    }
    if constexpr (WALK) {
      // The walked tiles, all lanes together. A tile that many lanes' rays
      // reach, each of them scans alone. One that few reach, the whole warp
      // tests for one of those rays at a time, each lane every 32nd record:
      // the nearest t and its record, or TIED; the ray's lane then takes
      // that record (with ties, the whole tile again in record order),
      // which is what its own scan of the tile would have kept.
      float idx = 0.f, idy = 0.f, idz = 0.f;
      if (active && !AXIS) {
        idx = clamped_rcp(dx);
        idy = clamped_rcp(dy);
        idz = clamped_rcp(dz);
      }
      for (int k = 0; k < n_walk; ++k) {
        const int tix = s_order[k];
        const float* T = s_tiles + tix * TILE;
        bool reach = false;
        if (active) {
          if constexpr (AXIS) {   // clamped_rcp's bits, from the IEEE reciprocals
            idx = fminf(fmaxf(ix, -BIG), BIG);
            idy = fminf(fmaxf(iy, -BIG), BIG);
            idz = fminf(fmaxf(iz, -BIG), BIG);
          }
          const float t1x = (T[0] - ox) * idx, t2x = (T[3] - ox) * idx;
          const float t1y = (T[1] - oy) * idy, t2y = (T[4] - oy) * idy;
          const float t1z = (T[2] - oz) * idz, t2z = (T[5] - oz) * idz;
          float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
          float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
          tn = tn - fabsf(tn) * 1e-3f;
          tf = tf + fabsf(tf) * 1e-3f;
          reach = (tf >= tn) && (tf > 0.f) && (tn < h.t);
        }
        if constexpr (DIAG) {
          if (reach) {
            const uint32_t pid = (uint32_t)i / (unsigned)p.block_rays;
            unsigned int* word = p.diag_mask +
                ((size_t)pid * p.max_segments + seg) * p.mask_words + (k >> 5);
            const unsigned int bit = 1u << (k & 31);
            if (!(*(volatile unsigned int*)word & bit)) atomicOr(word, bit);
          }
        }
        const unsigned need = __ballot_sync(FULL, reach);
        if (need == 0) continue;
        const int first = (int)T[6], count = (int)T[7], mode = (int)T[8];
        if constexpr (AXIS) {
          const int4 ax = s_axt[tix];
          if (ax.y > 0) {
            // An axis tile: the same two routes, pass 1 for the lanes whose
            // rays are finite (the general test for the others), then the
            // ray's own lane rescans the record at the tile's nearest t, or
            // where records tie on it, the whole tile in record order. A
            // lane takes `slots` entries when the warp tests the tile for
            // one ray.
            const unsigned fm = __ballot_sync(FULL, reach && fin);
            const int n_need = __popc(need), n_fin = __popc(fm);
            const int slots = ax.w + ((count - ax.z + 31) >> 5);
            const bool by_ray = n_need * (2 * slots + AXIS_RAY_COST) < 2 * count;
            if (lane == 0) {
              unsigned long long* c = warp_counts[threadIdx.x >> 5];
              c[TESTS_NEEDED] += (unsigned long long)n_need * count;
              if (by_ray) {
                c[TESTS_ISSUED] += 32ull * ((unsigned long long)n_fin * slots +
                                            (unsigned long long)(n_need - n_fin) *
                                                ((count + 31) >> 5));
                c[AXIS_TESTS] += 32ull * n_fin * ax.w;
              } else {
                c[TESTS_ISSUED] += 32ull * count * ((fm != 0) + (n_fin < n_need));
                if (fm != 0) c[AXIS_TESTS] += 32ull * ax.z;
              }
            }
            // Converged here and below wherever a collective follows a
            // divergent branch: without it the collectives take their slow
            // path for a warp that arrives split (40% of config_scale's
            // tracer time on the H100).
            __syncwarp();
            float best = BIG;   // for this lane's ray: the tile's nearest t
            int at = 0;         // and its record, or TIED
            if (by_ray) {
              for (unsigned todo = need; todo != 0; todo &= todo - 1) {
                const int j = __ffs(todo) - 1;
                const float jox = __shfl_sync(FULL, ox, j), joy = __shfl_sync(FULL, oy, j);
                const float joz = __shfl_sync(FULL, oz, j), jdx = __shfl_sync(FULL, dx, j);
                const float jdy = __shfl_sync(FULL, dy, j), jdz = __shfl_sync(FULL, dz, j);
                float lm = BIG;
                int li = 0;
                if ((fm >> j) & 1u) {
                  const float jix = __shfl_sync(FULL, ix, j), jiy = __shfl_sync(FULL, iy, j);
                  const float jiz = __shfl_sync(FULL, iz, j);
                  tile_axis_min<RESIDENT, GLASS>(ent, s_runs, ax, rec, first, 0, mode, lane, 32,
                                                 jox, joy, joz, jdx, jdy, jdz, jix, jiy, jiz,
                                                 t_min, lm, li);
                } else {
                  tile_general_min<RESIDENT, false, GLASS>(rec, sph, first, count, 0, mode, lane,
                                                           32, jox, joy, joz, jdx, jdy, jdz, 0.f,
                                                           0.f, t_min, lm, li);
                }
                float m = lm;
                for (int off = 16; off > 0; off >>= 1)
                  m = fminf(m, __shfl_xor_sync(FULL, m, off));
                // The tile's record at m, or TIED (a lane's own tie is
                // TIED, below every index).
                const unsigned at_m = __ballot_sync(FULL, lm == m);
                const int fi = __reduce_min_sync(FULL, lm == m ? li : 0x7fffffff);
                if (lane == (unsigned)j) {
                  best = m;
                  at = __popc(at_m) > 1 ? TIED : fi;
                }
                __syncwarp();
              }
            } else if (reach) {
              if (fin)
                tile_axis_min<RESIDENT, GLASS>(ent, s_runs, ax, rec, first, 0, mode, 0, 1, ox, oy,
                                               oz, dx, dy, dz, ix, iy, iz, t_min, best, at);
              else
                tile_general_min<RESIDENT, false, GLASS>(rec, sph, first, count, 0, mode, 0, 1,
                                                         ox, oy, oz, dx, dy, dz, 0.f, 0.f, t_min,
                                                         best, at);
            }
            __syncwarp();
            // The tile's record at its nearest t is taken as the scan takes
            // a nearer record; where records tie on it, the whole tile is
            // scanned again.
            const bool win = reach && best < h.t, tied = at == TIED;
            const int longest = __reduce_max_sync(FULL, win && tied ? count : 0);
            if (lane == 0) warp_counts[threadIdx.x >> 5][TESTS_ISSUED] += 32ull * longest;
            if (win) {
              own = false;
              if (tied) {
                scan_group<RESIDENT, PRIMS, GLASS, TEX>(rec, sph, ptex, stex, first, count, mode,
                                                        ox, oy, oz, dx, dy, dz, sdo, soo, t_min,
                                                        h, own);
              } else {
                const float4* R = rec + (size_t)(first + at) * RECORD4;
                take_row<RESIDENT, PRIMS, GLASS, TEX>(R, load4<RESIDENT>(R),
                                                      ptex + (size_t)(first + at) * TEX4, best, h,
                                                      own);
              }
            }
            __syncwarp();
            continue;
          }
        }
        // The warp tests the tile ray by ray when that costs less: per ray
        // ceil(count / 32) records a lane and the reductions (~1.5 records),
        // against `count` records once.
        const bool by_ray = __popc(need) * (2 * ((count + 31) >> 5) + 3) < 2 * count;
        if (lane == 0 && count > 0) {
          unsigned long long* c = warp_counts[threadIdx.x >> 5];
          c[TESTS_NEEDED] += (unsigned long long)__popc(need) * count;
          c[TESTS_ISSUED] += by_ray ? 32ull * __popc(need) * ((count + 31) >> 5) : 32ull * count;
        }
        if (by_ray) {
          float best = BIG;  // for this lane's ray: the tile's nearest t
          int at = 0;        // and its record, or TIED
          for (unsigned todo = need; todo != 0; todo &= todo - 1) {
            const int j = __ffs(todo) - 1;
            const float jox = __shfl_sync(FULL, ox, j), joy = __shfl_sync(FULL, oy, j);
            const float joz = __shfl_sync(FULL, oz, j), jdx = __shfl_sync(FULL, dx, j);
            const float jdy = __shfl_sync(FULL, dy, j), jdz = __shfl_sync(FULL, dz, j);
            float jsdo = 0.f, jsoo = 0.f;
            if constexpr (PRIMS) {
              jsdo = __shfl_sync(FULL, sdo, j);
              jsoo = __shfl_sync(FULL, soo, j);
            }
            float lm = BIG;
            int li = 0;
            tile_general_min<RESIDENT, PRIMS, GLASS>(rec, sph, first, count, 0, mode, lane, 32,
                                                     jox, joy, joz, jdx, jdy, jdz, jsdo, jsoo,
                                                     t_min, lm, li);
            float m = lm;
            for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, off));
            const unsigned at_m = __ballot_sync(FULL, lm == m);
            const int fi = __reduce_min_sync(FULL, lm == m ? li : 0x7fffffff);
            if (lane == (unsigned)j) {
              best = m;
              at = __popc(at_m) > 1 ? TIED : fi;
            }
          }
          // The rays' own lanes take their records: the warp issues the
          // longest of those scans in every lane.
          const bool tied = at == TIED;
          const int rescan = (reach && best < h.t) ? (tied ? count : 1) : 0;
          const int longest = __reduce_max_sync(FULL, rescan);
          if (lane == 0) warp_counts[threadIdx.x >> 5][TESTS_ISSUED] += 32ull * longest;
          if (rescan > 0) {
            own = false;
            scan_group<RESIDENT, PRIMS, GLASS, TEX>(rec, sph, ptex, stex,
                                                    tied ? first : first + at, rescan, mode, ox,
                                                    oy, oz, dx, dy, dz, sdo, soo, t_min, h, own);
          }
        } else if (reach) {
          own = false;
          scan_group<RESIDENT, PRIMS, GLASS, TEX>(rec, sph, ptex, stex, first, count, mode, ox,
                                                  oy, oz, dx, dy, dz, sdo, soo, t_min, h, own);
        }
      }
    }

    if (active) {
      const float t = h.t;
      if (!(t < BIG)) {
        if constexpr (SKY) {
          // lighting_factor^(segment - mirror hits) * strength, with 0^0 = 1.
          const float expo = (float)(seg - mh);
          const float fac = p.sky_lf > 0.f ? expf(expo * p.sky_log_lf) * p.sky_strength
                                           : (expo == 0.f ? p.sky_strength : 0.f);
          lr = lr + p.sky_r * fac; lg = lg + p.sky_g * fac; lb = lb + p.sky_b * fac;
        }
        dead = true;
      } else {
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
            const float cos_i =
                fminf(fmaxf(-((dhx * nex + dhy * ney) + dhz * nez), 0.0f), 1.0f);
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
              vx = dhx - 2.0f * dnh * nx; vy = dhy - 2.0f * dnh * ny;
              vz = dhz - 2.0f * dnh * nz;
            } else {
              vx = eta * dhx + coef * nex; vy = eta * dhy + coef * ney;
              vz = eta * dhz + coef * nez;
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
        dead = (spec && mh_new >= p.mirror_limit) || dc >= p.bounce_limit;
      }
      ++seg;   // the segments this ray entered alive
      dead = dead || seg >= p.max_segments;
      if (dead) {
        p.light[3 * i] = lr;
        p.light[3 * i + 1] = lg;
        p.light[3 * i + 2] = lb;
      }
    }
    if constexpr (DIAG) {
      // The lanes that finish a ray of the same reference block now make
      // its two atomics through one of them.
      const unsigned done = __ballot_sync(FULL, dead);
      if (dead) {
        const int pid = (int)((uint32_t)i / (unsigned)p.block_rays);
        const unsigned group = __match_any_sync(done, pid);
        const int most = __reduce_max_sync(group, seg);
        const int sum = __reduce_add_sync(group, seg);
        if (lane == (unsigned)(__ffs(group) - 1)) {
          const int n_blocks = (p.n_rays + p.block_rays - 1) / p.block_rays;
          atomicMax(p.diag_segments + pid, most);
          atomicAdd(p.diag_segments + n_blocks + pid, sum);
        }
      }
    }
    if (dead) i = -1;
  }

  // Add the warp's counts, with the single-tile groups' tests: every lane
  // slot of a warp-segment issues them, every live ray needs them.
  // Check in; the last warp out resets the work counters for the next launch.
  if (lane == 0) {
    const unsigned long long* c = warp_counts[threadIdx.x >> 5];
    unsigned long long single = 0;
    for (int ti = 0; ti < p.n_single; ++ti) single += (unsigned long long)s_tiles[ti * TILE + 7];
    atomicAdd(p.counters + RAY_SEGMENTS, c[RAY_SEGMENTS]);
    atomicAdd(p.counters + WARP_SEGMENTS, c[WARP_SEGMENTS]);
    // AXIS kernels count the single-tile groups' lane slots a segment at a time.
    atomicAdd(p.counters + TESTS_ISSUED,
              c[TESTS_ISSUED] + (AXIS ? 0ull : 32ull * single * c[WARP_SEGMENTS]));
    atomicAdd(p.counters + TESTS_NEEDED, c[TESTS_NEEDED] + single * c[RAY_SEGMENTS]);
    if (AXIS) atomicAdd(p.counters + AXIS_TESTS, c[AXIS_TESTS]);
    __threadfence();
    const unsigned warps = gridDim.x * (blockDim.x >> 5);
    if (atomicAdd(p.work + 1, 1u) == warps - 1u) {
      p.work[0] = 0;
      p.work[1] = 0;
      __threadfence();
    }
  }
}

// The launch geometry of one instantiation on the current device, found
// once per (device, shared memory): the block size whose blocks put the
// most warps on an SM (the larger block on a tie, so fewer blocks stage the
// scene), and how many of those blocks an SM holds.
struct Geometry {
  int device = -1;
  size_t smem = 0;
  int threads = 0, per_sm = 0, sms = 0, regs = 0;
};

template <typename K>
static cudaError_t geometry_of(K kernel, size_t smem, Geometry& g) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (g.device == dev && g.smem == smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  g.threads = g.per_sm = 0;
  for (int t = 32; t <= fa.maxThreadsPerBlock; t += 32) {
    int b = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, t, smem);
    if (e != cudaSuccess) return e;
    if (b > 0 && b * t >= g.per_sm * g.threads) {
      g.threads = t;
      g.per_sm = b;
    }
  }
  if (g.threads == 0) return cudaErrorInvalidConfiguration;  // does not fit on an SM
  g.regs = fa.numRegs;
  g.device = dev;
  g.smem = smem;
  return cudaSuccess;
}

// geometry (out, host): blocks, threads, shared bytes, registers, blocks per
// SM, resident (1) or not, the axis route (1) or not.
template <bool RESIDENT, bool WALK, bool SKY, bool PRIMS, bool GLASS, bool AXIS>
static int launch(const Params& p, int max_blocks, int* geometry, cudaStream_t stream) {
  constexpr bool TEX = MM_TEX, DIAG = MM_DIAG;
  if (TEX && ((p.n_planes > 0 && p.plane_tex == nullptr) ||
              (p.n_spheres > 0 && p.sphere_tex == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (DIAG && (p.diag_segments == nullptr || p.diag_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p.counters == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = trace_kernel<RESIDENT, WALK, SKY, PRIMS, GLASS, TEX, DIAG, AXIS>;
  const size_t smem = smem_bytes(p, RESIDENT, TEX, AXIS);
  static Geometry g[16];   // per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  Geometry local;
  Geometry& geo = dev < 16 ? g[dev] : local;
  e = geometry_of(kernel, smem, geo);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (long long)geo.sms * geo.per_sm;
  const long long needed = ((long long)p.n_rays + geo.threads - 1) / geo.threads;
  if (needed < blocks) blocks = needed;
  if (max_blocks > 0 && max_blocks < blocks) blocks = max_blocks;
  if (geometry != nullptr) {
    geometry[0] = (int)blocks;
    geometry[1] = geo.threads;
    geometry[2] = (int)smem;
    geometry[3] = geo.regs;
    geometry[4] = geo.per_sm;
    geometry[5] = RESIDENT;
    geometry[6] = AXIS;
  }
  if (p.n_rays > 0) kernel<<<(unsigned)blocks, geo.threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The axis route runs beside quads alone (no scene with triangles or
// spheres has its tables), so no AXIS kernel has the PRIMS stage.
template <bool RESIDENT, bool WALK, bool SKY, bool AXIS>
static int launch_stages(const Params& p, bool prims, bool glass, int max_blocks,
                         int* geometry, cudaStream_t s) {
  if constexpr (!AXIS) {
    if (prims)
      return glass ? launch<RESIDENT, WALK, SKY, true, true, false>(p, max_blocks, geometry, s)
                   : launch<RESIDENT, WALK, SKY, true, false, false>(p, max_blocks, geometry, s);
  }
  return glass ? launch<RESIDENT, WALK, SKY, false, true, AXIS>(p, max_blocks, geometry, s)
               : launch<RESIDENT, WALK, SKY, false, false, AXIS>(p, max_blocks, geometry, s);
}

template <bool RESIDENT, bool WALK, bool AXIS>
static int launch_sky(const Params& p, bool sky, bool prims, bool glass, int max_blocks,
                      int* geometry, cudaStream_t s) {
  return sky ? launch_stages<RESIDENT, WALK, true, AXIS>(p, prims, glass, max_blocks, geometry, s)
             : launch_stages<RESIDENT, WALK, false, AXIS>(p, prims, glass, max_blocks, geometry,
                                                          s);
}

// work: two zeroed words of this launch's stream (see Params::work), left
// zeroed by the launch. counters: COUNTS words the launch adds its counts
// to. max_blocks: at most this many blocks (0: as many as fill the card).
// axis_entries, axis_tiles, axis_runs: the pass-1 tables (Params), n_axis4 =
// 0 for a scene without axis records. geometry: 7 ints out, or null.
extern "C" int mm_trace_paths(const float* ori, const float* dirs, const float* planes,
                              int n_planes, const float* spheres, int n_spheres,
                              const float* plane_tex, const float* sphere_tex,
                              const float* tiles, int n_tiles, int n_single,
                              const int* order, const float* axis_entries, int n_axis4,
                              const int* axis_tiles, const int* axis_runs, int n_runs,
                              const int* seed, const float* seed_row,
                              float* light, unsigned int* work, unsigned long long* counters,
                              int* diag_segments, unsigned int* diag_mask,
                              int mask_words, int n_rays, int block_rays, int max_segments,
                              int bounce_limit, int mirror_limit, int prims, int glass,
                              int fresnel, float mirror_tint, float t_min, float sky_r,
                              float sky_g, float sky_b, float sky_strength, float sky_lf,
                              float sky_log_lf, int max_blocks, int* geometry,
                              void* stream) {
  const Params p = {ori, dirs, planes, spheres, tiles, order, seed, seed_row, light, work,
                    n_planes, n_spheres, n_tiles, n_single,
                    n_rays, block_rays, max_segments, bounce_limit, mirror_limit, fresnel,
                    mirror_tint, t_min,
                    sky_r, sky_g, sky_b, sky_strength, sky_lf, sky_log_lf,
                    plane_tex, sphere_tex, diag_segments, diag_mask, mask_words, counters,
                    axis_entries, axis_tiles, axis_runs, n_axis4, n_runs};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool sky = sky_strength != 0.f;
  // The whole scene resident when it fits, beside the warps' counts, the
  // shared memory a block of this device may opt in to.
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  // A scene of quads with axis records, traced with t_min > 0, takes the axis route
  // where its pass-1 tables fit: with the whole scene resident beside them,
  // or else with the records in global memory (pass 2 alone reads them).
  if (n_axis4 > 0 && t_min > 0.f && !prims) {
    if (smem_bytes(p, true, MM_TEX, true) + COUNT_BYTES <= (size_t)optin)
      return n_tiles > n_single
                 ? launch_sky<true, true, true>(p, sky, prims, glass, max_blocks, geometry, s)
                 : launch_sky<true, false, true>(p, sky, prims, glass, max_blocks, geometry, s);
    if (smem_bytes(p, false, MM_TEX, true) + COUNT_BYTES <= (size_t)optin)
      return launch_sky<false, true, true>(p, sky, prims, glass, max_blocks, geometry, s);
  }
  const bool resident = smem_bytes(p, true, MM_TEX, false) + COUNT_BYTES <= (size_t)optin;
  if (!resident)
    return launch_sky<false, true, false>(p, sky, prims, glass, max_blocks, geometry, s);
  if (n_tiles > n_single)
    return launch_sky<true, true, false>(p, sky, prims, glass, max_blocks, geometry, s);
  return launch_sky<true, false, false>(p, sky, prims, glass, max_blocks, geometry, s);
}
