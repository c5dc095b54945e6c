// Resolve: a frame's traced light into pixel colours, written as the
// chunk's rows of the screen; one thread a pixel's colour channel.
//
// Replaces the glue that XLA fuses under jit after the JAX package's tracer
// call (mirror_maze_tpu/render/pipeline.py:128-129 tone_map + jnp.mean and
// render/accumulate.py scatter_chunk_rows; no Pallas kernel). Its plain
// version is the port's render/frame_glue.py resolve_plain. For pixel k and
// channel c of K pixels x spp samples:
//   - each sample's tone map sqrt(max(l, 0)) (render/tracer.py tone_map; the
//     max passes NaN, as torch.clamp_min does and fmaxf does not);
//   - their sum in one fixed order, the order XLA-CPU's jitted jnp.mean sums
//     in for spp <= 32 and for multiples of 32: runs of 32 samples, each run
//     left to right, the runs' sums left to right; then times the float32
//     reciprocal of spp (render/frame_glue.py sample_mean);
//   - written to row ids[k / (cw * cw)] of the chunk-major screen at column
//     (k % (cw * cw)) * 3 + c (the chunk_pixels order), or to colour k of a
//     [K, 3] output where there are no ids (the offline render).
//
// Exactness: built with -fmad=false and IEEE square root; bitwise the plain
// version. The wrapper decides whether the rows land in a copy of the screen
// or in the screen itself (render/frame_glue.py resolve).
//
// Bound: bytes. The light is read once (12 B a sample) and the rows written
// once (12 B a pixel). A warp's 32 threads read ~11 pixels' samples, each
// thread its channel's word of every sample; the lines stay in the L1 while
// the warp walks them. Staging a block's light in shared memory with
// coalesced loads first, and unrolling the loads eight deep, were measured
// no faster (PERF.md §6).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 32;  // samples summed left to right before their run is added

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

__global__ void __launch_bounds__(THREADS) resolve_kernel(Params p) {
  const int o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= 3 * p.n_pixels) return;
  const int k = o / 3, c = o - 3 * k;
  const float* l = p.light + (size_t)k * p.spp * 3 + c;
  float total = 0.0f;
  for (int r0 = 0; r0 < p.spp; r0 += RUN) {
    const int end = r0 + RUN < p.spp ? r0 + RUN : p.spp;
    float run = tone(l[3 * r0]);
    for (int s = r0 + 1; s < end; ++s) run = run + tone(l[3 * s]);
    total = r0 == 0 ? run : total + run;
  }
  const float mean = total * p.rcp_spp;
  if (p.ids == nullptr) {
    p.out[o] = mean;
  } else {
    const int j = k / p.ppc, pn = k - j * p.ppc;
    p.out[(size_t)p.ids[j] * p.ppc * 3 + 3 * pn + c] = mean;
  }
}

}  // namespace

extern "C" int mm_resolve(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.n_pixels < 0 || p.spp < 1 || p.ppc < 1 || (p.ids != nullptr && p.n_pixels % p.ppc))
    return (int)cudaErrorInvalidValue;
  if (p.n_pixels == 0) return (int)cudaGetLastError();
  const int blocks = (3 * p.n_pixels + THREADS - 1) / THREADS;
  resolve_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
