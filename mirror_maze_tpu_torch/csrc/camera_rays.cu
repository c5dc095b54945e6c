// Camera rays: the tracer's input rays of a frame, one thread a sample ray,
// the directions one thread a pixel.
//
// Replaces the camera glue that XLA fuses under jit in the JAX package
// (mirror_maze_tpu/render/pipeline.py:70-75 with render/camera.py
// ray_directions, ops/sampling.py ray_jitter and render/scheduler.py
// chunk_origin_xy / chunk_pixels; no Pallas kernel). Its plain version is the
// port's render/frame_glue.py pinhole_rays_plain. For ray i of K pixels x spp
// samples (k = i / spp, sample s = i % spp):
//   - the pixel: from the chunk ids, pixel k of chunk ids[k / (cw * cw)] in
//     chunk_pixels order (x offset slow, y offset fast), its row moved down by
//     row0 (a band of a taller screen); or pixels[k] as given;
//   - the direction: normalize((px * rcp_w * vw - vw * 0.5,
//     py * rcp_h * vh - vh * 0.5, focal)), rotated by the camera quaternion,
//     the divisions by the screen's size as multiplies by the float32
//     reciprocals (render/camera.py ray_directions);
//   - the jitter: words 2i and 2i + 1 of jkey's draw as uniforms on [-1, 1)
//     (prng.uniform(jkey, (K, spp, 2), -1, 1)), times the jitter scale, added
//     to the direction; the z term adds 0 * scale;
//   - ori = the camera centre; with a noise texture the seed row is the
//     pixel's texel (utils/noise.py sample_noise, wrap-around addressing).
//
// Exactness: built with -fmad=false, one rounding an operation in the torch
// order; the root correctly rounded (ops/vecmath.py sqrt), the normalize a
// division by it; the rotation as quat.cuh; the draw as threefry.cuh. Every
// output bitwise the plain version's.
//
// Bound: the larger of 24 B written a ray (ori, dirs; 4 more with the seed
// row) and two hashes a ray of 79 int32 operations. The issue rate sets the
// time: a pixel's direction (its integer divisions, a root, three IEEE
// divisions, two Hamilton products) costs more instructions than a ray's two
// hashes, so a block of 256 rays first computes the directions of the pixels
// its rays sample (4 at 64 spp), one thread a pixel, into shared memory, and
// then one thread a ray draws its jitter and writes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quat.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;

// The C entry's parameters (the wrapper's ctypes Structure in
// render/frame_glue.py, field for field: pointers, then ints, then floats).
struct Params {
  const int* ids;           // [K / (cw * cw)] chunk ids, or null: pixels
  const int* pixels;        // [K, 2] (x, y) where ids is null
  const float* center;      // [3]
  const float* quat;        // [4]
  const float* focal;       // []
  const float* viewport;    // [2] (width, height)
  const long long* jkey;    // [2]
  const float* noise;       // [noise_h, noise_w], or null: no seed row
  float* ori;               // [R, 3]
  float* dirs;              // [R, 3]
  float* seed_row;          // [R] where noise is set
  int n_rays, spp, chunks_x, chunk_width, row0, noise_w, noise_h;
  int spp_log2;             // log2(spp) where spp is a power of two, else -1
  float rcp_w, rcp_h;       // float32 1 / width, 1 / height
  float jitter;
};

// Pixel k's direction (render/camera.py ray_directions) and, with a noise
// texture, its texel.
__device__ __forceinline__ void pixel(const Params& p, int k, float* dir, float* texel) {
  int px, py;
  if (p.ids != nullptr) {
    const int ppc = p.chunk_width * p.chunk_width;
    const int id = p.ids[k / ppc], pn = k % ppc;
    px = (id % p.chunks_x) * p.chunk_width + pn / p.chunk_width;
    py = (id / p.chunks_x) * p.chunk_width + p.row0 + pn % p.chunk_width;
  } else {
    px = p.pixels[2 * k];
    py = p.pixels[2 * k + 1];
  }
  const float vw = p.viewport[0], vh = p.viewport[1];
  float x = (float)px * p.rcp_w * vw - vw * 0.5f;
  float y = (float)py * p.rcp_h * vh - vh * 0.5f;
  float z = *p.focal;
  const float len = __fsqrt_rn((x * x + y * y) + z * z);
  x = x / len;
  y = y / len;
  z = z / len;
  mm::rotate(x, y, z, mm::load_quat(p.quat));
  dir[0] = x;
  dir[1] = y;
  dir[2] = z;
  if (p.noise != nullptr) {
    const int tx = px % p.noise_w, ty = py % p.noise_h;
    *texel = p.noise[(size_t)(ty < 0 ? ty + p.noise_h : ty) * p.noise_w +
                     (tx < 0 ? tx + p.noise_w : tx)];
  }
}

__global__ void __launch_bounds__(THREADS) camera_rays_kernel(Params p) {
  __shared__ float dir[THREADS][3];  // the block's pixels: at most one a ray
  __shared__ float texel[THREADS];
  const int i0 = blockIdx.x * THREADS;
  const int last = min(i0 + THREADS, p.n_rays) - 1;
  const int k0 = p.spp_log2 >= 0 ? i0 >> p.spp_log2 : i0 / p.spp;
  const int n_px = (p.spp_log2 >= 0 ? last >> p.spp_log2 : last / p.spp) - k0 + 1;
  for (int q = threadIdx.x; q < n_px; q += blockDim.x) pixel(p, k0 + q, dir[q], &texel[q]);
  __syncthreads();
  const mm::Key jkey = mm::load_key(p.jkey);
  for (int i = i0 + threadIdx.x; i <= last; i += blockDim.x) {
    const int q = (p.spp_log2 >= 0 ? i >> p.spp_log2 : i / p.spp) - k0;
    const float u0 = mm::to_uniform(mm::word(jkey, 2u * (uint32_t)i), -1.0f, 1.0f);
    const float u1 = mm::to_uniform(mm::word(jkey, 2u * (uint32_t)i + 1u), -1.0f, 1.0f);
    float* d = p.dirs + 3 * (size_t)i;
    d[0] = dir[q][0] + u0 * p.jitter;
    d[1] = dir[q][1] + u1 * p.jitter;
    d[2] = dir[q][2] + 0.0f * p.jitter;
    float* o = p.ori + 3 * (size_t)i;
    o[0] = p.center[0];
    o[1] = p.center[1];
    o[2] = p.center[2];
    if (p.noise != nullptr) p.seed_row[i] = texel[q];
  }
}

}  // namespace

extern "C" int mm_camera_rays(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.n_rays < 0 || p.spp < 1 || p.n_rays % p.spp || (p.ids == nullptr && p.pixels == nullptr) ||
      (p.ids != nullptr && (p.chunks_x < 1 || p.chunk_width < 1)) ||
      (p.noise != nullptr && (p.noise_w < 1 || p.noise_h < 1 || p.seed_row == nullptr)) ||
      (p.spp_log2 >= 0 && p.spp != 1 << p.spp_log2))
    return (int)cudaErrorInvalidValue;
  if (p.n_rays == 0) return (int)cudaGetLastError();
  const int blocks = (p.n_rays + THREADS - 1) / THREADS;
  camera_rays_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
