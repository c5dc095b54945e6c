// Present: feedback cross blur + optional 8-bit quantization on the
// chunk-major screen [C, cw*cw*3], one thread per output float.
//
// Replaces the JAX package's Pallas kernel
// mirror_maze_tpu/render/present.py::_present_kernel (launched by
// present_pallas), without the sharded halo variant. It is bitwise the
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
// Bound on the card: bytes. One read and one write of the screen; the
// neighbour reads of a warp hit the same or adjacent 48-float rows, which
// the L1/L2 caches serve.

#include <cuda_runtime.h>
#include <stdint.h>

#define RCP3 0x1.555556p-2f    // float32(1/3)
#define RCP255 0x1.010102p-8f  // float32(1/255)

__global__ void present_kernel(const float* __restrict__ src,
                               float* __restrict__ dst, int chunks_x,
                               int chunks_y, int cw, int quantize,
                               long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int row_len = cw * cw * 3;
  const long long c = e / row_len;
  const int j = (int)(e - c * row_len);
  const int ch = j % 3;
  const int yo = (j / 3) % cw;
  const int xo = j / (3 * cw);
  const int cx = (int)(c % chunks_x);
  const int cy = (int)(c / chunks_x);
  const float* row = src + c * row_len;
  const float t = row[j];

  float l, r, u, d;
  if (xo > 0) l = row[j - 3 * cw];
  else if (cx > 0) l = row[-row_len + (cw - 1) * 3 * cw + yo * 3 + ch];
  else l = t;
  if (xo < cw - 1) r = row[j + 3 * cw];
  else if (cx < chunks_x - 1) r = row[row_len + yo * 3 + ch];
  else r = t;
  if (yo > 0) u = row[j - 3];
  else if (cy > 0) u = row[-(long long)chunks_x * row_len + xo * 3 * cw + (cw - 1) * 3 + ch];
  else u = t;
  if (yo < cw - 1) d = row[j + 3];
  else if (cy < chunks_y - 1) d = row[(long long)chunks_x * row_len + xo * 3 * cw + ch];
  else d = t;

  float s = __fadd_rn(__fadd_rn(t, __fmul_rn(__fadd_rn(l, r), 0.5f)),
                      __fmul_rn(__fadd_rn(u, d), 0.5f));
  float out = __fmul_rn(s, RCP3);
  if (quantize) {
    float q = rintf(__fmul_rn(fminf(fmaxf(out, 0.0f), 1.0f), 255.0f));
    out = __fmul_rn(q, RCP255);
  }
  dst[e] = out;
}

extern "C" int mm_present(const float* src, float* dst, int chunks_x,
                          int chunks_y, int cw, int quantize, void* stream) {
  const long long n = (long long)chunks_x * chunks_y * cw * cw * 3;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (n > 0) {
    present_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        src, dst, chunks_x, chunks_y, cw, quantize, n);
  }
  return (int)cudaGetLastError();
}
