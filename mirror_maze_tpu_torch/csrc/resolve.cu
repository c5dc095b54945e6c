// Resolve: a frame's traced light into pixel colours, written as the
// chunk's rows of the screen; a block a run of PIXELS pixels, staged in
// shared memory.
//
// Replaces the glue that XLA fuses under jit after the JAX package's tracer
// call (mirror_maze_tpu/render/pipeline.py:128-129 tone_map + jnp.mean and
// render/accumulate.py scatter_chunk_rows; no Pallas kernel). Its plain
// version is the port's render/frame_glue.py resolve_plain. For pixel k and
// channel c of K pixels x spp samples:
//   - each sample's tone map sqrt(max(l, 0)) (render/tracer.py tone_map; the
//     max passes NaN, as torch.clamp_min does and fmaxf does not);
//   - their sum in one fixed order, the order XLA-CPU's jitted jnp.mean sums
//     in for spp <= 32, for multiples of 32 up to 1,024 and for multiples of
//     1,024: runs of 32 samples, each run left to right; blocks of 32 runs,
//     each the runs' sums left to right; the blocks' sums left to right; then
//     times the float32 reciprocal of spp (render/frame_glue.py sample_mean);
//   - written to row ids[k / (cw * cw)] of the chunk-major screen at column
//     (k % (cw * cw)) * 3 + c (the chunk_pixels order), or to colour k of a
//     [K, 3] output where there are no ids (the offline render).
//
// Exactness: built with -fmad=false and IEEE square root; bitwise the plain
// version. The wrapper decides whether the rows land in a copy of the screen
// or in the screen itself (render/frame_glue.py resolve).
//
// Bound: bytes. The light is read once (12 B a sample) and the rows written
// once (12 B a pixel). The first version (a thread a pixel's channel,
// reading its channel's word of every sample) spent ~11 L1 wavefronts a load
// on ~11 pixels' lines, and half its bound went there (PERF.md §6). Here a
// block:
//   1. reads its pixels' light, one contiguous span, with 16-byte loads and
//      tone-maps it into shared memory in the light's own order, PAD words
//      after every RUN_FLOATS (one run of RUN samples x 3 channels), so that
//      a run's floats start 4 banks after the run before;
//   2. sums each run of a pixel in one lane, its three channels side by side
//      left to right, reading the run with 16-byte loads (eight lanes of a
//      quarter warp hit eight different bank quads);
//   3. adds each pixel channel's runs in one lane, a block of BLOCK_RUNS
//      runs left to right and the blocks left to right, scales by the
//      reciprocal and writes the rows (consecutive lanes, consecutive
//      columns).
// The 16-byte route needs every run to start on 16 bytes: spp a multiple of
// RUN and the light 16-byte aligned. Any other spp, or a light that is not
// aligned, takes the same layout with 4-byte shared-memory accesses, and
// reads the span's unaligned head and tail one float at a time. A block
// stages at most SMEM_BYTES (no opt-in): PIXELS pixels, fewer where a
// pixel's samples are many, down to one pixel at RESOLVE_MAX_SPP = 3,816
// (render/frame_glue.py). 16 pixels a block of 128 threads measured fastest
// at [main]'s and config_scale's shapes (against 32 / 256, 32 / 128, 16 / 64
// and 8 / 64: PERF.md §6).
//
// Past RESOLVE_MAX_SPP (resolve_pieces_kernel) a block resolves one pixel,
// a block of BLOCK_RUNS runs (a piece) at a time, in the same order: it
// stages a piece's floats tone-mapped in the same padded layout (16-byte
// loads and, where the pixel's span is 16-byte aligned, 16-byte stores), a
// lane a run's channel sums it left to right, and lanes 0-2 add the piece's
// runs left to right and the piece's sum to their channel's total, which
// they hold from piece to piece in a register. So any spp fits the 13 KB a
// block stages.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int RUN = 32;                // samples summed left to right before their run is added
constexpr int RUN_FLOATS = 3 * RUN;    // one run's floats: RUN samples x 3 channels
constexpr int PAD = 4;                 // words after every RUN_FLOATS staged floats
constexpr int PIXELS = 16;             // pixels a block, at most
constexpr int SMEM_BYTES = 48 * 1024;  // a block's staging, at most
constexpr int BLOCK_RUNS = 32;         // runs summed left to right before their block is added

// The C entry's parameters (the wrapper's ctypes Structure in
// render/frame_glue.py, field for field: pointers, then ints, then floats).
struct Params {
  const float* light;  // [K * spp, 3]
  const int* ids;      // [K / ppc] chunk ids, or null: colours in K order
  float* out;          // [C, ppc * 3] screen rows, or [K, 3] colours
  int n_pixels, spp, ppc;
  float rcp_spp;       // float32 1 / spp
};

__device__ __forceinline__ float tone(float l) {
  return __fsqrt_rn(isnan(l) ? l : fmaxf(l, 0.0f));
}

// The shared-memory word of staged float f.
__host__ __device__ __forceinline__ int slot(int f) { return f + PAD * (f / RUN_FLOATS); }

// Shared-memory words of a block of `pixels` pixels: the staged light, then
// the runs' sums [pixels * 3, runs].
__host__ __device__ __forceinline__ int block_words(int pixels, int spp) {
  const int floats = pixels * 3 * spp, runs = (spp + RUN - 1) / RUN;
  return floats + PAD * ((floats + RUN_FLOATS - 1) / RUN_FLOATS) + pixels * 3 * runs;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) resolve_kernel(Params p, int pixels) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, span = 3 * p.spp, runs = (p.spp + RUN - 1) / RUN;
  const int k0 = blockIdx.x * pixels;
  const int np = min(pixels, p.n_pixels - k0), nf = np * span;
  const float* src = p.light + (size_t)k0 * span;
  float* sums = smem + block_words(pixels, p.spp) - pixels * 3 * runs;

  // 1. Stage the span, tone-mapped.
  if (VEC) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int q = tid; q < nf / 4; q += blockDim.x) {
      const float4 x = src4[q];
      *reinterpret_cast<float4*>(smem + slot(4 * q)) =
          make_float4(tone(x.x), tone(x.y), tone(x.z), tone(x.w));
    }
  } else {
    const int head = min(nf, (int)((16 - ((uintptr_t)src & 15)) & 15) / 4);
    const int body = (nf - head) / 4;
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    for (int f = tid; f < head; f += blockDim.x) smem[slot(f)] = tone(src[f]);
    for (int q = tid; q < body; q += blockDim.x) {
      const float4 x = src4[q];
      const int f = head + 4 * q;
      smem[slot(f)] = tone(x.x);
      smem[slot(f + 1)] = tone(x.y);
      smem[slot(f + 2)] = tone(x.z);
      smem[slot(f + 3)] = tone(x.w);
    }
    for (int f = head + 4 * body + tid; f < nf; f += blockDim.x) smem[slot(f)] = tone(src[f]);
  }
  __syncthreads();

  // 2. A lane a run of a pixel: each channel left to right.
  for (int t = tid; t < np * runs; t += blockDim.x) {
    const int px = t / runs, r = t - px * runs;
    int f = px * span + r * RUN_FLOATS;
    float a, b, c;
    if (VEC) {  // a whole run, RUN_FLOATS at slot(f) on 16 bytes: four samples in three loads
      const float4* run = reinterpret_cast<const float4*>(smem + slot(f));
      float4 x = run[0], y = run[1], z = run[2];
      a = x.x;
      b = x.y;
      c = x.z;
      a = a + x.w; b = b + y.x; c = c + y.y;
      a = a + y.z; b = b + y.w; c = c + z.x;
      a = a + z.y; b = b + z.z; c = c + z.w;
#pragma unroll
      for (int q = 3; q < RUN_FLOATS / 4; q += 3) {
        x = run[q];
        y = run[q + 1];
        z = run[q + 2];
        a = a + x.x; b = b + x.y; c = c + x.z;
        a = a + x.w; b = b + y.x; c = c + y.y;
        a = a + y.z; b = b + y.w; c = c + z.x;
        a = a + z.y; b = b + z.z; c = c + z.w;
      }
    } else {
      const int len = min(RUN, p.spp - r * RUN);
      a = smem[slot(f)];
      b = smem[slot(f + 1)];
      c = smem[slot(f + 2)];
      for (int s = 1; s < len; ++s) {
        f += 3;
        a = a + smem[slot(f)];
        b = b + smem[slot(f + 1)];
        c = c + smem[slot(f + 2)];
      }
    }
    float* out = sums + 3 * px * runs + r;
    out[0] = a;
    out[runs] = b;
    out[2 * runs] = c;
  }
  __syncthreads();

  // 3. A lane a pixel's channel: its runs by blocks, the mean, the row.
  for (int t = tid; t < 3 * np; t += blockDim.x) {
    const float* run = sums + t * runs;
    float total = 0.0f;
    for (int b = 0; b < runs; b += BLOCK_RUNS) {
      float block = run[b];
      const int end = min(runs, b + BLOCK_RUNS);
      for (int r = b + 1; r < end; ++r) block = block + run[r];
      total = b == 0 ? block : total + block;
    }
    const float mean = total * p.rcp_spp;
    const int px = t / 3, k = k0 + px;
    if (p.ids == nullptr) {
      p.out[(size_t)3 * k0 + t] = mean;
    } else {
      const int j = k / p.ppc, pn = k - j * p.ppc;
      p.out[(size_t)p.ids[j] * p.ppc * 3 + 3 * pn + (t - 3 * px)] = mean;
    }
  }
}

// Past RESOLVE_MAX_SPP: pixel blockIdx.x, a block of BLOCK_RUNS runs at a time.
__global__ void __launch_bounds__(THREADS) resolve_pieces_kernel(Params p) {
  __shared__ float4 stage4[BLOCK_RUNS * (RUN_FLOATS + PAD) / 4];
  __shared__ float sums[3 * BLOCK_RUNS];
  float* stage = reinterpret_cast<float*>(stage4);
  const int tid = threadIdx.x, k = blockIdx.x, runs = (p.spp + RUN - 1) / RUN;
  const long long span = 3LL * p.spp;
  const float* light = p.light + (size_t)k * span;
  const int head = (int)((16 - ((uintptr_t)light & 15)) & 15) / 4;  // floats to 16 bytes
  float total = 0.0f;
  for (int r0 = 0; r0 < runs; r0 += BLOCK_RUNS) {
    const int nr = min(BLOCK_RUNS, runs - r0);
    const float* src = light + (size_t)r0 * RUN_FLOATS;
    const int nf = (int)min((long long)nr * RUN_FLOATS, span - (long long)r0 * RUN_FLOATS);
    // 1. Stage the piece, tone-mapped (a piece starts 384 bytes after the
    //    one before, so every piece has the pixel's head).
    const int h = min(nf, head), body = (nf - h) / 4;
    const float4* src4 = reinterpret_cast<const float4*>(src + h);
    for (int f = tid; f < h; f += THREADS) stage[slot(f)] = tone(src[f]);
    for (int q = tid; q < body; q += THREADS) {
      const float4 x = src4[q];
      const int f = h + 4 * q;
      if (h == 0) {  // f % 4 == 0 and a run holds f..f+3: one 16-byte store
        *reinterpret_cast<float4*>(stage + slot(f)) =
            make_float4(tone(x.x), tone(x.y), tone(x.z), tone(x.w));
      } else {
        stage[slot(f)] = tone(x.x);
        stage[slot(f + 1)] = tone(x.y);
        stage[slot(f + 2)] = tone(x.z);
        stage[slot(f + 3)] = tone(x.w);
      }
    }
    for (int f = h + 4 * body + tid; f < nf; f += THREADS) stage[slot(f)] = tone(src[f]);
    __syncthreads();
    // 2. A lane a run's channel, its samples left to right.
    if (tid < 3 * nr) {
      const int r = tid / 3, c = tid - 3 * r;
      const int len = min(RUN, p.spp - (r0 + r) * RUN);
      const float* run = stage + slot(r * RUN_FLOATS);  // a run's floats are contiguous
      float a = run[c];
      if (len == RUN) {
#pragma unroll
        for (int s = 1; s < RUN; ++s) a = a + run[3 * s + c];
      } else {
        for (int s = 1; s < len; ++s) a = a + run[3 * s + c];
      }
      sums[c * BLOCK_RUNS + r] = a;
    }
    __syncthreads();
    // 3. Lanes 0-2: the piece's runs left to right, then into their
    //    channel's total. The next piece's stage writes only `stage`; its
    //    barrier comes before its sums are written.
    if (tid < 3) {
      float block = sums[tid * BLOCK_RUNS];
      for (int r = 1; r < nr; ++r) block = block + sums[tid * BLOCK_RUNS + r];
      total = r0 == 0 ? block : total + block;
    }
  }
  if (tid < 3) {
    const float mean = total * p.rcp_spp;
    if (p.ids == nullptr) {
      p.out[(size_t)3 * k + tid] = mean;
    } else {
      const int j = k / p.ppc, pn = k - j * p.ppc;
      p.out[(size_t)p.ids[j] * p.ppc * 3 + 3 * pn + tid] = mean;
    }
  }
}

}  // namespace

extern "C" int mm_resolve(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.n_pixels < 0 || p.spp < 1 || p.ppc < 1 || (p.ids != nullptr && p.n_pixels % p.ppc))
    return (int)cudaErrorInvalidValue;
  if (p.n_pixels == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  int pixels = p.spp <= SMEM_BYTES / 4 ? PIXELS : 0;  // a larger spp overflows no int below
  while (pixels > 0 && block_words(pixels, p.spp) * 4 > SMEM_BYTES) --pixels;
  if (pixels == 0) {  // past RESOLVE_MAX_SPP
    resolve_pieces_kernel<<<p.n_pixels, THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)block_words(pixels, p.spp) * 4;
  const int blocks = (p.n_pixels + pixels - 1) / pixels;
  if (p.spp % RUN == 0 && ((uintptr_t)p.light & 15) == 0)
    resolve_kernel<true><<<blocks, THREADS, smem, s>>>(p, pixels);
  else
    resolve_kernel<false><<<blocks, THREADS, smem, s>>>(p, pixels);
  return (int)cudaGetLastError();
}
