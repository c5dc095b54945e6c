// BVH walk: the nearest hit of every ray by the ordered stack traversal of
// the jnp tracer's bvh backend, one thread a ray, then the fold of the
// scene's spheres.
//
// Replaces the `jax.lax.while_loop` of the JAX package's
// mirror_maze_tpu/render/intersect.py::nearest_hit_bvh (a loop over every
// ray at once, not a Pallas kernel). Its plain version is the port's
// render/intersect.py nearest_hit_bvh, a masked vector loop in which every
// update is gated by the ray's own `live`: rays are independent, so walking
// one ray until it is no longer live gives that loop's result bit for bit.
// Spheres are not in the BVH; the kernel folds them in after the walk, as
// the plain version's _merge_spheres does.
//
// Inputs, float32 (render/intersect.py bvh_tables):
//   noderow  [M, 14]: per node both children's boxes (bmin, bmax of the left
//            child, then of the right) and (count, left_first) as exact floats;
//   leafpack [N, L*15]: per primitive slot the whole leaf run that starts
//            there, 15 floats a slot (normal, d, w1, b1, w2, b2, valid,
//            scene id, triangle flag);
//   spheres: centre [S, 3], c2r2 [S], ior [S] or null (no glass);
//   ori, dirs [R, 3];
//   ids [R] int32 and count [1] int32 on the device, or both null: the list
//   of the rays to walk (render/tracer.py: the rays alive at this segment,
//   appended by the shade kernel), of which the first *count are read.
// Outputs: t [R] float32 (1e30 = miss), idx [R] int32 (scene-order id;
// sphere i is n_planes + i); with a list, only the listed rays' entries are
// written. The grid is sized for R either way, so a segment's walk is one
// launch whose count a CUDA graph holds on the device; threads past the
// count walk nothing.
// Work counters (render/intersect.py COUNTERS), added by every launch to an
// int64 buffer [STRIPES, STRIPE_WIDTH] on the device: rays walked (a warp's
// ballot), nodes visited (the walk loop's own count) and the threads the
// launch started (block 0 adds its grid).
// Each warp sums its lanes' visits and adds them with one atomic a counter,
// to the stripe of its block, so that the atomics of a launch spread over
// STRIPES lines of 128 bytes; the reader sums the stripes. The node count
// takes 37 and 39 registers where the walk alone took 32 (rays and threads
// alone keep 32; no way of counting the visits tried kept fewer than 36),
// fewer warps an SM. On an H100 (PERF.md §6, in turns with the walk before
// the counters): +3.0% a launch over every ray, +1.6% on 21 segments of
// config_scale, -3.6% on a shuffled live list, +0.6% to +0.9% on
// interactive-bvh's frame.
//
// Exactness against the plain version (built with -fmad=false and IEEE
// division, as every kernel of the port):
// - dots sum as (a0*b0 + a1*b1) + a2*b2; tk = (d - o.n) / (d.n) is a true
//   division; the hit point is o + tk*d, a multiply then an add; the slab
//   reciprocals are 1/d;
// - the slab test: torch.minimum / maximum and amax / amin propagate NaN
//   ((bmin - o) * inf where bmin == o), and a NaN makes every comparison
//   false, so one NaN among the six slab distances is a miss. fminf / fmaxf
//   drop NaN, so that rule is written out before them;
// - visit order: the near child first (d1 <= d2 -> the left one), the far
//   one pushed when it is hit too; a leaf's slots k < min(count, L) in
//   order; a hit replaces the current one only when strictly nearer;
// - the stack: a push writes slot min(sp, levels - 1), a pop reads
//   stack[sp - 1] (0 past the levels), as the plain version clamps;
// - the sphere fold is intersect.py sphere_ts and _merge_spheres: b = d.o -
//   d.c, q = o.o + (o.(-2c) + c2r2), disc = b*b - q, root = sqrt(disc) (a
//   correctly rounded __fsqrt_rn), the near root -b - root past t_min, else
//   for a glass sphere (ior > 0) the far root -b + root; the first least
//   sphere distance wins, and it replaces the plane hit only when strictly
//   nearer.
//
// A ray holds at most one pending node a level below the root, so a stack
// of max_depth + 2 levels never fills; one too shallow would send the plain
// walk round for ever (a pop past the levels restarts at the root). A walk
// visits each node at most once, so the kernel stops a ray after M visits:
// that bound is never reached where the stack holds, and it keeps a wrong
// max_depth from hanging the card.
//
// Design: one thread walks its ray to the end with its stack in a
// per-thread array (local memory, cached in the L1), the tables read
// through the L1, a block per 128 rays, 32 registers. Measured against it on
// the H100 (PERF.md, PR 12): tables staged in shared memory, rows of 16
// floats read as float4, the stack in shared memory as [level][thread] and
// a persistent grid were each slower on the main path's frame-1 rays or on
// their bounces (more registers, fewer warps an SM, the staging repeated by
// every block), so the walk stays this one, with the sphere fold added in
// an instance of its own (SPHERES): the fold's code alone, never run, made
// the planes-only walk 2% slower on the H100.

#include <cuda_runtime.h>

#define MM_BVH_STACK 64  // levels a ray's stack holds (intersect.BVH_STACK)
#define MM_BVH_STRIPES 32  // stripes of the work counters (intersect.COUNTER_STRIPES)

namespace {

constexpr float BIG = 1e30f;
constexpr int NODE_WIDTH = 14;
constexpr int SLOT_WIDTH = 15;
constexpr int THREADS = 128;
constexpr int STRIPE_WIDTH = 16;  // int64 a stripe: one 128-byte line

// Entry distance of the ray into the box (bmin = box[0:3], bmax = box[3:6]),
// or BIG: render/intersect.py _slab.
__device__ __forceinline__ float slab(const float* __restrict__ box, float ox, float oy,
                                      float oz, float ix, float iy, float iz, float t_cur) {
  const float t1x = (box[0] - ox) * ix, t2x = (box[3] - ox) * ix;
  const float t1y = (box[1] - oy) * iy, t2y = (box[4] - oy) * iy;
  const float t1z = (box[2] - oz) * iz, t2z = (box[5] - oz) * iz;
  if (isnan(t1x) || isnan(t2x) || isnan(t1y) || isnan(t2y) || isnan(t1z) || isnan(t2z))
    return BIG;
  const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  return (tf >= tn && tn < t_cur && tf > 0.0f) ? tn : BIG;
}

// One ray's walk and sphere fold, its t and idx written; returns the nodes
// it visited.
template <bool SPHERES>
__device__ __forceinline__ int walk_ray(
    const float* __restrict__ noderow, const float* __restrict__ leafpack, int n_nodes,
    int n_slots, int max_leaf, const float* __restrict__ sph_center,
    const float* __restrict__ sph_c2r2, const float* __restrict__ sph_ior, int n_spheres,
    int n_planes, const float* __restrict__ ori, const float* __restrict__ dirs,
    float* __restrict__ t_out, int* __restrict__ idx_out, int r, int n_levels, float t_min) {
  const float ox = ori[3 * r], oy = ori[3 * r + 1], oz = ori[3 * r + 2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const size_t leaf_row = (size_t)max_leaf * SLOT_WIDTH;
  float t = BIG;
  int idx = 0;
  int stack[MM_BVH_STACK];
  int sp = 0, cur = 0;
  int visit = 0;
  for (; visit < n_nodes; ++visit) {
    const float* nr = noderow + (size_t)cur * NODE_WIDTH;
    const int ct = (int)nr[12];
    const int lf = (int)nr[13];
    if (ct >= 1) {
      // A leaf: its primitives in slot order.
      const float* lp = leafpack + (size_t)min(max(lf, 0), n_slots - 1) * leaf_row;
      const int n = min(ct, max_leaf);
      for (int k = 0; k < n; ++k) {
        const float* pk = lp + k * SLOT_WIDTH;
        const float denom = (dx * pk[0] + dy * pk[1]) + dz * pk[2];
        const float tk = (pk[3] - ((ox * pk[0] + oy * pk[1]) + oz * pk[2])) / denom;
        const float px = ox + tk * dx, py = oy + tk * dy, pz = oz + tk * dz;
        const float s1 = ((px * pk[4] + py * pk[5]) + pz * pk[6]) - pk[7];
        const float s2 = ((px * pk[8] + py * pk[9]) + pz * pk[10]) - pk[11];
        const bool inside = pk[14] > 0.0f ? s1 + s2 <= 1.0f : (s1 <= 1.0f && s2 <= 1.0f);
        if (pk[12] > 0.0f && denom != 0.0f && tk > t_min && s1 >= 0.0f && s2 >= 0.0f &&
            inside && tk < t) {
          t = tk;
          idx = (int)pk[13];
        }
      }
    } else {
      // Interior: follow the near child, push the far one when it is hit too.
      const float d1 = slab(nr, ox, oy, oz, ix, iy, iz, t);
      const float d2 = slab(nr + 6, ox, oy, oz, ix, iy, iz, t);
      const bool first = d1 <= d2;
      if (fminf(d1, d2) < BIG) {
        if (fmaxf(d1, d2) < BIG) {
          stack[min(sp, n_levels - 1)] = first ? lf + 1 : lf;
          ++sp;
        }
        cur = first ? lf : lf + 1;
        continue;
      }
    }
    // A leaf, or a missed interior node: pop the latest far child, or stop.
    if (sp == 0) {
      ++visit;
      break;
    }
    --sp;
    cur = sp < n_levels ? stack[sp] : 0;
  }
  if (SPHERES) {
    // The sphere fold: the least sphere distance (the first on a tie), taken
    // where strictly nearer than the plane hit.
    const float sdo = (ox * dx + oy * dy) + oz * dz;
    const float soo = (ox * ox + oy * oy) + oz * oz;
    float ts_min = BIG;
    int s_idx = 0;
    for (int s = 0; s < n_spheres; ++s) {
      const float cx = sph_center[3 * s], cy = sph_center[3 * s + 1], cz = sph_center[3 * s + 2];
      const float b = sdo - ((dx * cx + dy * cy) + dz * cz);
      const float q =
          soo + (((ox * (-2.0f * cx) + oy * (-2.0f * cy)) + oz * (-2.0f * cz)) + sph_c2r2[s]);
      const float disc = b * b - q;
      const float root = __fsqrt_rn(fmaxf(disc, 0.0f));
      float ts = -b - root;
      bool ok = disc > 0.0f && ts > t_min;
      if (!ok && sph_ior != nullptr) {
        const float tf = -b + root;
        if (disc > 0.0f && tf > t_min && sph_ior[s] > 0.0f) {
          ts = tf;
          ok = true;
        }
      }
      if (ok && ts < ts_min) {
        ts_min = ts;
        s_idx = s;
      }
    }
    if (ts_min < t) {
      t = ts_min;
      idx = n_planes + s_idx;
    }
  }
  t_out[r] = t;
  idx_out[r] = idx;
  return visit;
}

template <bool SPHERES>
__global__ void __launch_bounds__(THREADS)
    bvh_walk(const float* __restrict__ noderow, const float* __restrict__ leafpack,
             int n_nodes, int n_slots, int max_leaf, const float* __restrict__ sph_center,
             const float* __restrict__ sph_c2r2, const float* __restrict__ sph_ior,
             int n_spheres, int n_planes, const float* __restrict__ ori,
             const float* __restrict__ dirs, float* __restrict__ t_out,
             int* __restrict__ idx_out, const int* __restrict__ ids,
             const int* __restrict__ count, int n_rays, int n_levels, float t_min,
             unsigned long long* __restrict__ counts) {
  int r = blockIdx.x * THREADS + threadIdx.x;
  // Every lane of a warp reaches the count's sums below, so a lane with no
  // ray to walk skips the walk instead of returning.
  bool walks;
  if (ids != nullptr) {
    walks = r < min(*count, n_rays);
    if (walks) r = ids[r];
  } else {
    walks = r < n_rays;
  }
  unsigned visits = 0u;
  if (walks) {
    visits = walk_ray<SPHERES>(noderow, leafpack, n_nodes, n_slots, max_leaf, sph_center,
                               sph_c2r2, sph_ior, n_spheres, n_planes, ori, dirs, t_out,
                               idx_out, r, n_levels, t_min);
  }
  const unsigned rays = __popc(__ballot_sync(0xffffffffu, walks));
  const unsigned nodes = __reduce_add_sync(0xffffffffu, visits);
  unsigned long long* stripe =
      counts + (size_t)(blockIdx.x & (MM_BVH_STRIPES - 1)) * STRIPE_WIDTH;
  if ((threadIdx.x & 31) == 0 && rays != 0u) {
    atomicAdd(stripe, (unsigned long long)rays);
    atomicAdd(stripe + 1, (unsigned long long)nodes);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(stripe + 2, (unsigned long long)gridDim.x * THREADS);
}

}  // namespace

// spheres: n_spheres of them (0: no fold); sph_ior null where no sphere is glass.
// ids, count: the rays to walk, or both null for every ray.
// counts: the work counters, int64 [MM_BVH_STRIPES, 16].
extern "C" int mm_bvh_walk(const float* noderow, const float* leafpack, int n_nodes,
                           int n_slots, int max_leaf, const float* sph_center,
                           const float* sph_c2r2, const float* sph_ior, int n_spheres,
                           int n_planes, const float* ori, const float* dirs, float* t, int* idx,
                           const int* ids, const int* count, int n_rays, int n_levels,
                           float t_min, unsigned long long* counts, void* stream) {
  if (n_levels < 1 || n_levels > MM_BVH_STACK || n_nodes < 1 || n_slots < 1 || max_leaf < 1 ||
      n_spheres < 0 || (n_spheres > 0 && (sph_center == nullptr || sph_c2r2 == nullptr)) ||
      (ids == nullptr) != (count == nullptr) || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return (int)cudaGetLastError();
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  auto kernel = n_spheres > 0 ? bvh_walk<true> : bvh_walk<false>;
  kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      noderow, leafpack, n_nodes, n_slots, max_leaf, sph_center, sph_c2r2, sph_ior, n_spheres,
      n_planes, ori, dirs, t, idx, ids, count, n_rays, n_levels, t_min, counts);
  return (int)cudaGetLastError();
}
