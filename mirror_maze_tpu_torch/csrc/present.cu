// Present: feedback cross blur + optional 8-bit quantization on the
// chunk-major screen [C, cw*cw*3], one thread per strip of a chunk.
//
// Replaces the JAX package's Pallas kernel
// mirror_maze_tpu/render/present.py::_present_kernel (launched by
// present_pallas), both variants: the single screen, and with two halo rows
// the row band of a screen cut across several devices (`halo=True` there,
// launched by parallel/shard.py _present_with_halo). It is bitwise the
// reference engine's blur + quantize (render/accumulate.py feedback_blur_cm
// + quantize_8bit as the engine runs them, under jit):
//   out = (c + (l + r) * 0.5 + (u + d) * 0.5) * float32(1/3)
//   q   = rint(clip(out, 0, 1) * 255) * float32(1/255)
// XLA compiles each division by a constant into a multiply by the float32
// reciprocal, on the CPU as on the TPU, so that is what is matched; halving
// is exact either way. Round half to even, and every operation rounded on
// its own (__f*_rn: no contraction into multiply-adds).
//
// Neighbours in chunk-major order: a pixel (cy, cx, xo, yo, ch) sits at
// row cy*Cx + cx, column (xo*cw + yo)*3 + ch. Inside a chunk the x and y
// neighbours are xo/yo shifts; across a chunk edge they are the adjacent
// chunk's edge column or row; at the screen edge the value clamps to the
// pixel itself.
//
// Halo variant: the screen is a band of pixel rows of a taller one. Its top
// pixel row reads `u` from `halo_top` and its bottom row `d` from
// `halo_bot`, the neighbouring bands' adjacent pixel rows, each a plain
// pixel row [width * 3] = [Cx, cw, 3] indexed by (cx, xo, ch). (The
// reference embeds each row at the lane offsets of a chunk row, for the
// TPU's lane shifts; that layout is not carried over.) The outermost bands
// are given their own edge row, which is the clamp. Null pointers mean the
// single screen, so one kernel serves both.
//
// Bound on the card: bytes, one read and one write of the screen (plus two
// pixel rows). The design streams them in 16-byte words with 32-bit index
// math and no division at all:
//
// - a 2-D grid: blockIdx.y is the chunk row cy, and a thread takes one
//   strip, the cw pixels of one column x = cx * cw + xo of that chunk row
//   (the cw * 3 floats at column xo * 3 * cw of chunk row cy * Cx + cx).
//   Strip (cy, x) starts at float (cy * W + x) * 3 * cw, W = Cx * cw the
//   screen width, so consecutive threads take consecutive strips and the
//   strips of a chunk row are in pixel column order: a multiply, no divide;
// - for cw = 4 (every configuration's chunk width) a strip is 12 floats,
//   three float4s at a 48-byte offset: three 16-byte loads and three
//   16-byte stores a thread. The left and right neighbours are the strips of
//   the lanes beside it (x - 1 and x + 1, across a chunk edge or not), taken
//   with __shfl_up_sync / __shfl_down_sync; lanes 0 and 31 load the strip
//   beyond the warp. The pixels above and below are the strip's own, except
//   at its ends, where one 16-byte load of the chunk row above (its strip's
//   last float4) or below (its first) or a halo row gives them;
// - any other chunk width (the configuration allows 1-42) runs the generic
//   instance of the same source: the same grid, a loop over the strip's cw
//   pixels with scalar loads, its neighbours from memory.
//
// A thread past the screen's right edge takes the last column's strip, so
// every lane of a warp joins the shuffles, and stores nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define RCP3 0x1.555556p-2f    // float32(1/3)
#define RCP255 0x1.010102p-8f  // float32(1/255)
#define FULL 0xffffffffu
#define THREADS 128

__device__ __forceinline__ float blur(float t, float l, float r, float u, float d,
                                      int quantize) {
  float s = __fadd_rn(__fadd_rn(t, __fmul_rn(__fadd_rn(l, r), 0.5f)),
                      __fmul_rn(__fadd_rn(u, d), 0.5f));
  float out = __fmul_rn(s, RCP3);
  if (quantize) {
    float q = rintf(__fmul_rn(fminf(fmaxf(out, 0.0f), 1.0f), 255.0f));
    out = __fmul_rn(q, RCP255);
  }
  return out;
}

__device__ __forceinline__ void load12(const float* p, float* v) {
  const float4* q = (const float4*)p;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 w = __ldg(q + k);
    v[4 * k] = w.x; v[4 * k + 1] = w.y; v[4 * k + 2] = w.z; v[4 * k + 3] = w.w;
  }
}

// Chunk width 4: a strip is 12 floats (yo, ch), three float4s.
__global__ void present_cw4(const float* __restrict__ src, float* __restrict__ dst,
                            const float* __restrict__ halo_top,
                            const float* __restrict__ halo_bot, int width, int chunks_y,
                            int quantize) {
  const int cy = blockIdx.y;
  const int xt = blockIdx.x * THREADS + threadIdx.x;
  const int x = xt < width ? xt : width - 1;
  const unsigned lane = threadIdx.x & 31u;
  const size_t strip = (size_t)cy * width + x;
  const float* me = src + strip * 12;
  float c[12], l[12], r[12], up[3], dn[3];
  load12(me, c);
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    l[k] = __shfl_up_sync(FULL, c[k], 1);
    r[k] = __shfl_down_sync(FULL, c[k], 1);
  }
  // The warp's edge lanes, and the screen's edges (the pixel itself).
  if (lane == 0) {
    if (x > 0) load12(me - 12, l);
    else for (int k = 0; k < 12; ++k) l[k] = c[k];
  }
  if (lane == 31) {
    if (x < width - 1) load12(me + 12, r);
    else for (int k = 0; k < 12; ++k) r[k] = c[k];
  }
  if (cy > 0) {
    const float4 w = __ldg((const float4*)(me - (size_t)width * 12) + 2);  // yo 3 at .yzw
    up[0] = w.y; up[1] = w.z; up[2] = w.w;
  } else if (halo_top != nullptr) {
    for (int ch = 0; ch < 3; ++ch) up[ch] = halo_top[x * 3 + ch];
  } else {
    for (int ch = 0; ch < 3; ++ch) up[ch] = c[ch];
  }
  if (cy < chunks_y - 1) {
    const float4 w = __ldg((const float4*)(me + (size_t)width * 12));      // yo 0 at .xyz
    dn[0] = w.x; dn[1] = w.y; dn[2] = w.z;
  } else if (halo_bot != nullptr) {
    for (int ch = 0; ch < 3; ++ch) dn[ch] = halo_bot[x * 3 + ch];
  } else {
    for (int ch = 0; ch < 3; ++ch) dn[ch] = c[9 + ch];
  }
  float o[12];
#pragma unroll
  for (int yo = 0; yo < 4; ++yo) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int k = yo * 3 + ch;
      const float u = yo > 0 ? c[k - 3] : up[ch];
      const float d = yo < 3 ? c[k + 3] : dn[ch];
      o[k] = blur(c[k], l[k], r[k], u, d, quantize);
    }
  }
  if (xt < width) {
    float4* out = (float4*)(dst + strip * 12);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
  }
}

// Any chunk width: a strip of cw pixels, one at a time, scalar loads.
__global__ void present_any(const float* __restrict__ src, float* __restrict__ dst,
                            const float* __restrict__ halo_top,
                            const float* __restrict__ halo_bot, int width, int chunks_y,
                            int cw, int quantize) {
  const int cy = blockIdx.y;
  const int x = blockIdx.x * THREADS + threadIdx.x;
  if (x >= width) return;
  const int n = cw * 3;  // floats a strip
  const size_t strip = (size_t)cy * width + x;
  const float* me = src + strip * n;
  const float* left = x > 0 ? me - n : me;
  const float* right = x < width - 1 ? me + n : me;
  for (int yo = 0; yo < cw; ++yo) {
    for (int ch = 0; ch < 3; ++ch) {
      const int k = yo * 3 + ch;
      const float t = me[k];
      float u, d;
      if (yo > 0) u = me[k - 3];
      else if (cy > 0) u = me[-(ptrdiff_t)width * n + (cw - 1) * 3 + ch];
      else u = halo_top ? halo_top[x * 3 + ch] : t;
      if (yo < cw - 1) d = me[k + 3];
      else if (cy < chunks_y - 1) d = me[(ptrdiff_t)width * n + ch];
      else d = halo_bot ? halo_bot[x * 3 + ch] : t;
      dst[strip * n + k] = blur(t, left[k], right[k], u, d, quantize);
    }
  }
}

extern "C" int mm_present(const float* src, float* dst, const float* halo_top,
                          const float* halo_bot, int chunks_x, int chunks_y, int cw,
                          int quantize, void* stream) {
  if ((halo_top == nullptr) != (halo_bot == nullptr)) return (int)cudaErrorInvalidValue;
  if (chunks_y > 65535) return (int)cudaErrorInvalidValue;
  const int width = chunks_x * cw;
  if (width <= 0 || chunks_y <= 0) return (int)cudaGetLastError();
  const dim3 grid((width + THREADS - 1) / THREADS, chunks_y);
  const cudaStream_t s = (cudaStream_t)stream;
  if (cw == 4)
    present_cw4<<<grid, THREADS, 0, s>>>(src, dst, halo_top, halo_bot, width, chunks_y,
                                         quantize);
  else
    present_any<<<grid, THREADS, 0, s>>>(src, dst, halo_top, halo_bot, width, chunks_y, cw,
                                         quantize);
  return (int)cudaGetLastError();
}
