// Frame setup: the scalar work of one frame of the engine step, in two
// blocks: block 0 pops and sorts the window, block 1 draws the frame's keys
// and moves the camera.
//
// Replaces the glue that XLA fuses under jit around the JAX package's two
// Pallas calls (mirror_maze_tpu/runtime/step.py:155-183; no Pallas kernel):
// the queue pop, the Morton sort of the window, the WASD move and its
// collision test, and the key chain of the frame. Its plain version is the
// port's runtime/step.py frame_setup_plain, the torch ops that ran here
// before (~180 launches a frame on the card):
//   1. ids = perm[(cursor + i) % total], i < n; cursor' = (cursor + n) % total
//      (render/scheduler.py take_chunks), then with the sort flag the ids in
//      the order of morton2(id % chunks_x, id / chunks_x) (sort_window_morton);
//   2. moved = center + delta, delta = ((-right * a - fwd * s) + right * d) +
//      fwd * w with right, fwd the rotations of (step, 0, 0) and (0, 0, step)
//      by the camera quaternion (runtime/step.py integrate_movement);
//      center' = center where the player's box [moved - half, moved + half]
//      overlaps any leaf box (closed intervals; scene/collision.py collides),
//      else moved;
//   3. the key chain: rkey, key' = split(key) (rotation_update's split);
//      fkey = fold_in(key', frame + 1); jkey, tkey = split(fkey) (camera_rays);
//      seed = randint(tkey, (), lo, hi) (frame_rays): split(tkey) into k1, k2,
//      higher = word 0 of k1, lower = word 0 of k2, folded modulo the span
//      with the wrapping uint32 products of jax.random.randint.
//
// The window's ids are distinct (a window never exceeds the queue), so are
// their Morton codes, and any correct sort gives the stable argsort's order.
// The codes are sorted by a bitonic network, padded with 0xFFFFFFFF to a
// power of two of at least a warp's codes, and decoded back into ids (a
// chunk's coordinates are < 2^16, so the code holds them whole; the wrapper
// raises on a larger grid, where the reference's 16-bit codes collide). A
// window of at most MAX_SORT ids is sorted by block 0 alone; a larger one
// (config_scale at 7680x4320 pops 32,400) by the tiled route below.
//
// Exactness: built with -fmad=false (IEEE division and root, no contraction,
// as every kernel of the port): the move is the torch expression order (see
// quat.cuh); the collision compares the same float32 box corners; the key
// chain is threefry.cuh's hash. Every buffer it writes is bitwise the plain
// version's.
//
// Bound: latency. A few hundred bytes, nine hashes and the sort's
// n log^2 n / 4 compare-exchanges (66 steps at 1,980 ids, 91 at 8,040) on
// one SM, whose issue rate set the first version's time (one block of 1,024
// threads, a pair a thread and a barrier a step, the key chain on thread 0
// before the first barrier: PERF.md §6). The design takes that path apart:
//   - the sort holds E = CODES codes a thread in registers (more where the
//     width needs more than MAX_THREADS threads), a block of them
//     consecutive (thread t holds t * E + e): a step of distance j below E
//     compares registers, one below a warp's codes swaps with lane
//     lane ^ (j / E) by __shfl_xor_sync, and only the steps of a larger j
//     go through shared memory (two buffers in turn, one barrier a step):
//     10 of the 66 steps at 1,980 ids (16 warps), 15 of the 91 at 8,040
//     (E = 8, 32 warps). The network is unrolled for each width (a
//     template), so no step spends instructions on its loop, its kind or
//     its direction. The sort is latency-bound: more warps with fewer codes
//     each won (E = 4 against 8 and 16; 2 tied with 4: PERF.md §6);
//   - the key chain, the move and the collision test run in block 1, on
//     another SM, beside the sort; inside the chain the independent hashes
//     (the rotation split's two children, the camera split's two, randint's
//     two) go to two lanes, so its depth is five hashes.
//
// The tiled route, a window of n > MAX_SORT ids: the first launch has one
// block a tile of TILE ids (the last tile shorter), each sorting its tile's
// codes with the network above into the scratch buffer `codes`, and the
// setup block last. Then ceil(log2(tiles)) merge passes, one launch each,
// merge pairs of sorted runs: an element's place in its pair is its index in
// its run plus the codes of the other run below it (a binary search; the
// codes are distinct, so no two are equal). The last pass decodes into ids.
// n is a host int, so the launches are fixed by it and a CUDA graph captures
// them all. One block's network grows faster than its codes, and the merge
// passes spread over every SM, so the tiles are small: at 32,400 ids 16
// tiles of 2,048 (4 codes on 512 threads) and 4 passes, 0.021 ms on the
// H100, against 0.086 with tiles of 16,384, 0.022 of 4,096, 0.023 of 1,024
// and 0.052 for an LSD radix sort of the grid's 22 code bits in three 8-bit
// passes (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quat.cuh"
#include "threefry.cuh"

namespace {

constexpr int MAX_SORT = 16384;     // codes a block sorts
constexpr int TILE = 2048;          // codes a tile of the tiled route (a power of two)
constexpr int CODES = 4;            // codes a sorting thread holds, at least
constexpr int WARP = 32;
constexpr int MAX_THREADS = 1024;
constexpr int MERGE_THREADS = 256;  // a merge pass's block
constexpr unsigned FULL = 0xFFFFFFFFu;

// The C entry's parameters (the wrapper's ctypes Structure in
// runtime/step.py, field for field: pointers, then ints, then floats).
struct Params {
  // The state and the frame's input row.
  const int* perm;          // [total] chunk queue
  const int* cursor;        // []
  const long long* key;     // [2] uint32 words
  const int* frame;         // []
  const float* center;      // [3]
  const float* quat;        // [4]
  const float* input;       // [>= 4] keys A, S, D, W as 0.0 / 1.0
  const float* leaf_min;    // [leaves, 3] the scene's collision boxes
  const float* leaf_max;    // [leaves, 3]
  // Outputs.
  int* ids;                 // [n]
  int* cursor_out;          // []
  int* frame_out;           // []
  float* center_out;        // [3]
  long long* key_out;       // [2] the state's next key
  long long* keys_out;      // [3, 2] rkey, jkey, tkey
  int* seed_out;            // [1]
  uint32_t* codes;          // [2, n] scratch of the tiled route (n > MAX_SORT), else null
  int total, n, sort, chunks_x, leaves;
  int seed_min;             // randint's minval
  unsigned int seed_span;   // (maxval - minval) as uint32, 1 for an empty range
  unsigned int seed_mult;   // (2^16 % span)^2 as uint32, % span
  float step;               // move_speed / fps
  float half_x, half_y, half_z;  // the player's half extent
};

__device__ __forceinline__ uint32_t spread(uint32_t v) {  // ops/morton.py morton2
  v &= 0xFFFFu;
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

__device__ __forceinline__ uint32_t compact(uint32_t v) {  // spread's inverse
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  v = (v | (v >> 8)) & 0x0000FFFFu;
  return v;
}

// The id of a Morton code (spread's inverse on both coordinates).
__device__ __forceinline__ int decode(uint32_t v, int chunks_x) {
  return (int)compact(v >> 1) * chunks_x + (int)compact(v);
}

__device__ __forceinline__ void store_key(long long* out, mm::Key k) {
  out[0] = (long long)k.k1;
  out[1] = (long long)k.k2;
}

__device__ __forceinline__ mm::Key lane_key(mm::Key k, int lane) {
  return mm::Key{__shfl_sync(FULL, k.k1, lane), __shfl_sync(FULL, k.k2, lane)};
}

// Warp 0 of block 1: the key chain and the seed. Lane l hashes child l & 1
// where a step has two independent children; every lane computes the same
// chain, lanes 0 and 1 hand theirs on by shuffles.
__device__ void key_chain(const Params& p, uint32_t frame, int lane) {
  const uint32_t half = lane & 1;
  const mm::Key split = mm::child(mm::load_key(p.key), half);   // rkey, next
  const mm::Key next = lane_key(split, 1);
  const mm::Key pair = mm::child(mm::child(next, frame), half);  // jkey, tkey
  const mm::Key tkey = lane_key(pair, 1);
  const uint32_t w = mm::word(mm::child(tkey, half), 0);         // higher, lower
  const uint32_t higher = __shfl_sync(FULL, w, 0), lower = __shfl_sync(FULL, w, 1);
  if (lane == 1) {
    store_key(p.key_out, next);
    store_key(p.keys_out + 4, tkey);
  }
  if (lane != 0) return;
  const uint64_t span = p.seed_span;
  uint64_t offset = (((uint64_t)(higher % span) * p.seed_mult) & 0xFFFFFFFFull) + lower % span;
  offset = (offset & 0xFFFFFFFFull) % span;
  store_key(p.keys_out, split);
  store_key(p.keys_out + 2, pair);
  *p.seed_out = (int)((uint32_t)p.seed_min + (uint32_t)offset);
}

// The moved centre (runtime/step.py integrate_movement).
__device__ void move(const Params& p, float* moved) {
  const mm::Quat q = mm::load_quat(p.quat);
  float rx = p.step, ry = 0.0f, rz = 0.0f;
  float fx = 0.0f, fy = 0.0f, fz = p.step;
  mm::rotate(rx, ry, rz, q);
  mm::rotate(fx, fy, fz, q);
  const float a = p.input[0], s = p.input[1], d = p.input[2], w = p.input[3];
  moved[0] = p.center[0] + (((-rx * a - fx * s) + rx * d) + fx * w);
  moved[1] = p.center[1] + (((-ry * a - fy * s) + ry * d) + fy * w);
  moved[2] = p.center[2] + (((-rz * a - fz * s) + rz * d) + fz * w);
}

// Block 1: the keys, the counters, the move and its collision test.
__device__ void setup_block(const Params& p) {
  __shared__ float moved[3];
  const int tid = threadIdx.x;
  if (tid < WARP) {
    const uint32_t frame = (uint32_t)*p.frame + 1u;
    key_chain(p, frame, tid);
    if (tid == 0) {
      *p.frame_out = (int)frame;
      *p.cursor_out = (int)((*p.cursor + (long long)p.n) % p.total);
    }
  } else if (tid == WARP) {
    move(p, moved);
  }
  __syncthreads();
  const float lo_x = moved[0] - p.half_x, lo_y = moved[1] - p.half_y, lo_z = moved[2] - p.half_z;
  const float hi_x = moved[0] + p.half_x, hi_y = moved[1] + p.half_y, hi_z = moved[2] + p.half_z;
  int hit = 0;
  for (int l = tid; l < p.leaves; l += blockDim.x) {
    const float* mn = p.leaf_min + 3 * l;
    const float* mx = p.leaf_max + 3 * l;
    hit |= (lo_x <= mx[0]) & (hi_x >= mn[0]) & (lo_y <= mx[1]) & (hi_y >= mn[1]) &
           (lo_z <= mx[2]) & (hi_z >= mn[2]);
  }
  hit = __syncthreads_or(hit);
  if (tid < 3) p.center_out[tid] = hit ? p.center[tid] : moved[tid];
}

// A compare-exchange step of distance J < E inside a thread's codes: the
// pair (e, e + J), e with bit J clear; ascending where the element's k-block
// ascends.
template <int E, int J>
__device__ __forceinline__ void exchange_registers(uint32_t (&v)[E], int i0, int k) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e & J) continue;
    const bool up = ((i0 + e) & k) == 0;
    const uint32_t lo = min(v[e], v[e + J]), hi = max(v[e], v[e + J]);
    v[e] = up ? lo : hi;
    v[e + J] = up ? hi : lo;
  }
}

template <int E>
__device__ __forceinline__ void register_step(uint32_t (&v)[E], int i0, int j, int k) {
  if (j == 1) exchange_registers<E, 1>(v, i0, k);
  if (j == 2) exchange_registers<E, 2>(v, i0, k);
  if constexpr (E > 4) if (j == 4) exchange_registers<E, 4>(v, i0, k);
  if constexpr (E > 8) if (j == 8) exchange_registers<E, 8>(v, i0, k);
}

// The element keeps the smaller code where it is the lower of its pair in an
// ascending k-block, or the upper in a descending one.
__device__ __forceinline__ uint32_t keep(uint32_t mine, uint32_t theirs, bool keep_min) {
  return keep_min ? min(mine, theirs) : max(mine, theirs);
}

// A step of distance j = E * m, m < 32: the partner is lane lane ^ m's
// register e.
template <int E>
__device__ __forceinline__ void exchange_lanes(uint32_t (&v)[E], int lane, int m, bool up) {
  const bool keep_min = ((lane & m) == 0) == up;
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = keep(v[e], __shfl_xor_sync(FULL, v[e], m), keep_min);
}

// A step of distance j >= a warp's codes: through the shared buffer buf,
// which no thread reads in the step before (the caller alternates two).
template <int E>
__device__ __forceinline__ void exchange_shared(uint32_t (&v)[E], uint32_t* buf, int i0, int j,
                                                bool up) {
  static_assert(E % 4 == 0, "a thread stores its codes as 16-byte words");
  uint4* mine = reinterpret_cast<uint4*>(buf + i0);
#pragma unroll
  for (int q = 0; q < E / 4; ++q)
    mine[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  __syncthreads();
  const uint4* theirs = reinterpret_cast<const uint4*>(buf + (i0 ^ j));
  const bool keep_min = ((i0 & j) == 0) == up;
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const uint4 w = theirs[q];
    v[4 * q] = keep(v[4 * q], w.x, keep_min);
    v[4 * q + 1] = keep(v[4 * q + 1], w.y, keep_min);
    v[4 * q + 2] = keep(v[4 * q + 2], w.z, keep_min);
    v[4 * q + 3] = keep(v[4 * q + 3], w.w, keep_min);
  }
}

// Block 0: the window, and with the sort flag its bitonic sort of W = 2^L
// codes (W >= WARP * E; W / E threads, or a warp more). TILED: block b
// sorts the window's ids [b W, b W + W) into codes[b W ...], undecoded.
template <int E, int L, bool TILED>
__device__ void window_block(const Params& p, uint32_t* buf) {
  constexpr int W = 1 << L;
  const int tid = threadIdx.x;
  const int cursor = *p.cursor;  // in [0, total)
  if (!p.sort) {
    for (int i = tid; i < p.n; i += blockDim.x)
      p.ids[i] = p.perm[((uint32_t)cursor + i) % (uint32_t)p.total];
    return;
  }
  const int base = TILED ? (int)blockIdx.x * W : 0;
  const int count = TILED ? min(W, p.n - base) : p.n;
  const int i0 = tid * E;
  if (i0 >= W) return;  // the second warp of a one-warp sort: it has no barrier
  uint32_t v[E];
  int at = i0 < count ? (int)(((uint32_t)cursor + (uint32_t)(base + i0)) % (uint32_t)p.total) : 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (i0 + e < count) {
      const int id = p.perm[at];
      v[e] = spread((uint32_t)(id % p.chunks_x)) | (spread((uint32_t)(id / p.chunks_x)) << 1);
    } else {
      v[e] = 0xFFFFFFFFu;
    }
    at = at + 1 == p.total ? 0 : at + 1;
  }
  const int lane = tid & (WARP - 1);
  int parity = 0;
#pragma unroll
  for (int a = 1; a <= L; ++a) {
    const int k = 1 << a;
#pragma unroll
    for (int b = a - 1; b >= 0; --b) {
      const int j = 1 << b;
      if (j >= WARP * E) {
        exchange_shared<E>(v, buf + parity * W, i0, j, (i0 & k) == 0);
        parity ^= 1;
      } else if (j >= E) {
        exchange_lanes<E>(v, lane, j / E, (i0 & k) == 0);
      } else {
        register_step<E>(v, i0, j, k);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (i0 + e >= count) continue;
    if (TILED)
      p.codes[base + i0 + e] = v[e];
    else
      p.ids[i0 + e] = decode(v[e], p.chunks_x);
  }
}

// The window blocks, then the setup block (the last).
template <int E, int L, bool TILED>
__global__ void __launch_bounds__(MAX_THREADS) frame_setup_kernel(Params p) {
  extern __shared__ uint4 smem[];  // [2, 2^L] codes with the sort flag
  if (blockIdx.x == gridDim.x - 1)
    setup_block(p);
  else
    window_block<E, L, TILED>(p, reinterpret_cast<uint32_t*>(smem));
}

// A merge pass of the tiled route: the n codes of src in sorted runs of
// `run` (the last one shorter) merged pairwise into dst, or on the last pass
// decoded into ids. A thread an element.
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const uint32_t* src, uint32_t* dst, int* ids, int n, int run, int chunks_x) {
  const int i = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (i >= n) return;
  const int r = i / run;
  const long long other = (long long)(r ^ 1) * run;  // the other run of the pair
  const int len = other < n ? (int)min((long long)run, n - other) : 0;
  const uint32_t x = src[i];
  const uint32_t* o = src + (len > 0 ? other : 0);
  int lo = 0, hi = len;  // the other run's codes below x: [0, lo)
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (o[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  const long long at = (long long)(r & ~1) * run + (i - (long long)r * run) + lo;
  if (ids != nullptr)
    ids[at] = decode(x, chunks_x);
  else
    dst[at] = x;
}

// Opt the instantiation in to the shared memory past 48 KiB, once per device.
template <int E, int L, bool TILED>
int allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  static bool opted[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        frame_setup_kernel<E, L, TILED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted[device] = true;
  }
  return (int)cudaSuccess;
}

// The launch of a sort of 2^L codes (or, with no sort flag, of none).
template <int L>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int W = 1 << L;
  constexpr int E = W / MAX_THREADS > CODES ? W / MAX_THREADS : CODES;
  constexpr int sort_threads = W / E > 2 * WARP ? W / E : 2 * WARP;
  const int threads = p.sort ? sort_threads : MAX_THREADS;
  const size_t smem = p.sort ? 2 * (size_t)W * sizeof(uint32_t) : 0;
  const int err = allow_smem<E, L, false>(smem);
  if (err != (int)cudaSuccess) return err;
  frame_setup_kernel<E, L, false><<<2, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

constexpr int log2_of(int n) { return n > 1 ? 1 + log2_of(n / 2) : 0; }

// The launch of the width 2^log, from 2^L up.
template <int L>
int launch_log(const Params& p, int log, cudaStream_t stream) {
  if constexpr (L > log2_of(MAX_SORT))
    return (int)cudaErrorInvalidValue;
  else
    return log == L ? launch<L>(p, stream) : launch_log<L + 1>(p, log, stream);
}

constexpr int MIN_LOG = log2_of(WARP * CODES);  // a warp's codes, the least width

// The tiled route: a block a tile of TILE ids and the setup block, then the
// merge passes, the last into ids.
int launch_tiles(const Params& p, cudaStream_t stream) {
  constexpr int L = log2_of(TILE);
  constexpr int E = TILE / MAX_THREADS > CODES ? TILE / MAX_THREADS : CODES;
  static_assert(TILE / E <= MAX_THREADS && TILE / E >= WARP, "a tile's threads");
  const size_t smem = 2 * (size_t)TILE * sizeof(uint32_t);
  int err = allow_smem<E, L, true>(smem);
  if (err != (int)cudaSuccess) return err;
  const int tiles = (p.n + TILE - 1) / TILE;
  frame_setup_kernel<E, L, true><<<tiles + 1, TILE / E, smem, stream>>>(p);
  err = (int)cudaGetLastError();
  uint32_t* src = p.codes;
  uint32_t* dst = p.codes + p.n;
  const int blocks = (p.n + MERGE_THREADS - 1) / MERGE_THREADS;
  for (long long run = TILE; err == (int)cudaSuccess && run < p.n; run *= 2) {
    const bool last = 2 * run >= p.n;
    merge_kernel<<<blocks, MERGE_THREADS, 0, stream>>>(src, last ? nullptr : dst,
                                                       last ? p.ids : nullptr, p.n, (int)run,
                                                       p.chunks_x);
    err = (int)cudaGetLastError();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  return err;
}

}  // namespace

extern "C" int mm_frame_setup(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  const bool tiled = p.sort && p.n > MAX_SORT;
  if (p.n < 1 || p.total < p.n || p.chunks_x < 1 || p.leaves < 0 || p.seed_span == 0 ||
      (tiled && p.codes == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (tiled) return launch_tiles(p, s);
  int log = MIN_LOG;
  while (p.sort && (1 << log) < p.n) ++log;
  return launch_log<MIN_LOG>(p, log, s);
}
