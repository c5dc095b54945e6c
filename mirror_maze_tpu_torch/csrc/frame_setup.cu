// Frame setup: the scalar work of one frame of the engine step, in one
// block.
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
// The codes are sorted in shared memory by a bitonic network, padded with
// 0xFFFFFFFF to a power of two, and decoded back into ids (a chunk's
// coordinates are < 2^16, so the code holds them whole). The wrapper raises
// before the launch on a window of more than MAX_SORT ids.
//
// Exactness: built with -fmad=false (IEEE division and root, no contraction,
// as every kernel of the port): the move is the torch expression order (see
// quat.cuh); the collision compares the same float32 box corners; the key
// chain is threefry.cuh's hash. Every buffer it writes is bitwise the plain
// version's.
//
// Bound: latency. A few hundred bytes, nine hashes and the sort's
// n log^2 n / 4 compare-exchanges (66 barrier steps at 1,980 ids, 91 at
// 8,040) in one block of 1,024 threads on one SM, whose four schedulers'
// issue rate sets the sort's time, so a thread takes one pair a step. (A
// thread a code, half of them idle, issued twice the instructions; ending
// the steps inside a warp at a warp barrier saved nothing: PERF.md §6.) The
// key chain and the move run on thread 0 while the others load the codes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quat.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_SORT = 16384;  // codes a block sorts: 64 KiB of shared memory

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

__device__ __forceinline__ void store_key(long long* out, mm::Key k) {
  out[0] = (long long)k.k1;
  out[1] = (long long)k.k2;
}

// Thread 0: the key chain and the seed.
__device__ void key_chain(const Params& p, uint32_t frame) {
  const mm::Key key = mm::load_key(p.key);
  const mm::Key rkey = mm::child(key, 0), next = mm::child(key, 1);
  const mm::Key fkey = mm::child(next, frame);
  const mm::Key jkey = mm::child(fkey, 0), tkey = mm::child(fkey, 1);
  const uint32_t higher = mm::word(mm::child(tkey, 0), 0);
  const uint32_t lower = mm::word(mm::child(tkey, 1), 0);
  const uint64_t span = p.seed_span;
  uint64_t offset = (((uint64_t)(higher % span) * p.seed_mult) & 0xFFFFFFFFull) + lower % span;
  offset = (offset & 0xFFFFFFFFull) % span;
  store_key(p.key_out, next);
  store_key(p.keys_out, rkey);
  store_key(p.keys_out + 2, jkey);
  store_key(p.keys_out + 4, tkey);
  *p.seed_out = (int)((uint32_t)p.seed_min + (uint32_t)offset);
}

// Thread 0: the moved centre (runtime/step.py integrate_movement).
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

__global__ void __launch_bounds__(THREADS) frame_setup_kernel(Params p, int width) {
  extern __shared__ uint32_t codes[];  // [width] with the sort flag
  __shared__ float moved[3];
  const int tid = threadIdx.x;
  const long long cursor = *p.cursor;
  if (tid == 0) {
    const uint32_t frame = (uint32_t)*p.frame + 1u;
    key_chain(p, frame);
    move(p, moved);
    *p.frame_out = (int)frame;
    *p.cursor_out = (int)((cursor + p.n) % p.total);
  }
  // 1. The window: its ids, or their Morton codes to sort.
  for (int i = tid; i < (p.sort ? width : p.n); i += blockDim.x) {
    const int id = i < p.n ? p.perm[(cursor + i) % p.total] : 0;
    if (!p.sort) {
      p.ids[i] = id;
    } else {
      codes[i] = i < p.n ? spread((uint32_t)(id % p.chunks_x)) |
                               (spread((uint32_t)(id / p.chunks_x)) << 1)
                         : 0xFFFFFFFFu;
    }
  }
  __syncthreads();
  // 2. The collision test of the moved box against every leaf box.
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
  for (int c = tid; c < 3; c += blockDim.x) p.center_out[c] = hit ? p.center[c] : moved[c];
  if (!p.sort) return;
  // 3. The bitonic sort of the codes, ascending: a step is width / 2
  // compare-exchanges of the pairs (i, i + j), i with bit j clear, one a
  // thread, both codes written back (min first where i's k-block ascends).
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < width / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1)), l = i | j;
        const uint32_t a = codes[i], b = codes[l];
        const uint32_t lo = a < b ? a : b, hi = a < b ? b : a;
        const bool up = (i & k) == 0;
        codes[i] = up ? lo : hi;
        codes[l] = up ? hi : lo;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < p.n; i += blockDim.x) {
    const uint32_t c = codes[i];
    p.ids[i] = (int)compact(c >> 1) * p.chunks_x + (int)compact(c);
  }
}

}  // namespace

extern "C" int mm_frame_setup(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.n < 1 || p.total < p.n || p.chunks_x < 1 || p.leaves < 0 || p.seed_span == 0 ||
      (p.sort && p.n > MAX_SORT))
    return (int)cudaErrorInvalidValue;
  int width = 0;
  if (p.sort)
    for (width = 1; width < p.n; width <<= 1) {
    }
  const size_t smem = (size_t)width * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    // Opt in to the shared memory past 48 KiB, once per device.
    static bool opted[64] = {};
    int device = 0;
    cudaGetDevice(&device);
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (!opted[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          frame_setup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SORT * 4);
      if (err != cudaSuccess) return (int)err;
      opted[device] = true;
    }
  }
  frame_setup_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(p, width);
  return (int)cudaGetLastError();
}
