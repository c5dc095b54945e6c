// Fused path tracer: the whole bounce loop of one ray per CUDA thread.
//
// Replaces the JAX package's Pallas kernel
// mirror_maze_tpu/render/pallas_tracer.py::_tracer_kernel (launched by
// _trace_padded), for the slice the maze runs: opaque, untextured quads in
// three closed-world test modes (0: full quad test, 1: along-wall edge test
// only, 2: no edge test), one plane tile, no sky term, no noise seed row.
// It computes what that kernel computes under the CPU interpreter, ray for
// ray (render/fused_tracer.py trace_paths_plain is the same arithmetic in
// PyTorch):
//
// - per segment, the nearest hit over all planes: t = numer * (1/denom)
//   (IEEE reciprocal, then a multiply — not numer/denom), edge tests
//   min(s, 1-s) >= 0 per tested edge, t > t_min, misses at BIG = 1e30;
// - planes that tie exactly on the nearest t SUM their properties, as the
//   reference's one-hot select does;
// - emission pickup, albedo attenuation, mirror tint and reflection, the
//   diffuse scatter from one PCG word split into two 16-bit uniforms and
//   the reference's _sinpi polynomial, one 1/sqrt normalization;
// - the PCG stream of ray i is seeded by (seed, pid = i / B, r = i % B)
//   with B the reference's rays per Pallas program, so the launch geometry
//   here never changes the image.
//
// A lane that dies changes nothing in the reference's block-wide loop, so
// each thread simply stops at its own death.
//
// Bound on the card: operations. Each live (ray, plane) pair costs ~20
// f32 operations plus one IEEE reciprocal; the plane table (a few KB) is
// staged in shared memory once per block and every thread reads the same
// plane at the same time (a broadcast), so memory traffic is only the
// rays in and the light out. Build with -fmad=false: a contracted
// multiply-add would round differently from the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#define BIG 1e30f
#define RECORD 20  // floats per plane record (render/scenebuf.py RECORD_WIDTH)

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

__global__ void trace_kernel(const float* __restrict__ ori,
                             const float* __restrict__ dirs,
                             const float* __restrict__ planes, int n_planes,
                             int n_mode0, int n_mode1,
                             const int* __restrict__ seed_ptr,
                             float* __restrict__ light, int n_rays,
                             int block_rays, int max_segments, int bounce_limit,
                             int mirror_limit, float mirror_tint, float t_min) {
  extern __shared__ float sp[];
  for (int k = threadIdx.x; k < n_planes * RECORD; k += blockDim.x) sp[k] = planes[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  // PCG init (_pcg_init): seed + pid * 2654435761 + r * 15823, then two
  // scramble rounds (the scramble's output becomes the state).
  const uint32_t pid = (uint32_t)(i / block_rays);
  const uint32_t r = (uint32_t)(i % block_rays);
  uint32_t rng = (uint32_t)seed_ptr[0] + pid * 2654435761u + r * 15823u;
  for (int k = 0; k < 2; ++k) rng = pcg_scramble(rng);

  float ox = ori[3 * i], oy = ori[3 * i + 1], oz = ori[3 * i + 2];
  float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  float tr = 1.f, tg = 1.f, tb = 1.f;
  float lr = 0.f, lg = 0.f, lb = 0.f;
  int mh = 0, dc = 0;
  const int edge2_end = n_mode0;            // planes [0, n_mode0): both edges
  const int edge1_end = n_mode0 + n_mode1;  // planes [.., edge1_end): s1 edge

  for (int seg = 0; seg < max_segments; ++seg) {
    // Nearest hit and the (tie-summed) properties of the winner.
    float tmin = BIG;
    float nx = 0.f, ny = 0.f, nz = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
    float er = 0.f, eg = 0.f, eb = 0.f, mir = 0.f;
    for (int p = 0; p < n_planes; ++p) {
      const float* P = sp + p * RECORD;
      float numer = P[3] - ((P[0] * ox + P[1] * oy) + P[2] * oz);
      float denom = (P[0] * dx + P[1] * dy) + P[2] * dz;
      float t = numer * (1.0f / denom);
      bool ok = t > t_min;
      if (p < edge1_end) {
        float s1 = (((P[4] * ox + P[5] * oy) + P[6] * oz) - P[7]) +
                   t * ((P[4] * dx + P[5] * dy) + P[6] * dz);
        ok = ok && (s1 >= 0.f) && (1.0f - s1 >= 0.f);
        if (p < edge2_end) {
          float s2 = (((P[8] * ox + P[9] * oy) + P[10] * oz) - P[11]) +
                     t * ((P[8] * dx + P[9] * dy) + P[10] * dz);
          ok = ok && (s2 >= 0.f) && (1.0f - s2 >= 0.f);
        }
      }
      float tv = ok ? t : BIG;
      if (tv < tmin) {
        tmin = tv;
        nx = P[0]; ny = P[1]; nz = P[2];
        cr = P[12]; cg = P[13]; cb = P[14];
        er = P[15]; eg = P[16]; eb = P[17];
        mir = P[18];
      } else if (tv == tmin && tv < BIG) {
        nx += P[0]; ny += P[1]; nz += P[2];
        cr += P[12]; cg += P[13]; cb += P[14];
        er += P[15]; eg += P[16]; eb += P[17];
        mir += P[18];
      }
    }

    const float t = tmin;
    const bool hit = t < BIG;
    const float dn = (dx * nx + dy * ny) + dz * nz;
    const float side = dn > 0.f ? -1.f : (dn < 0.f ? 1.f : -dn);  // -sign(dn)
    const bool mirror = hit && (mir > 0.f) && (side != -1.f);
    const bool diffuse = hit && !mirror;
    const int mh_new = mh + (mirror ? 1 : 0);
    const bool mirror_live = mirror && (mh_new < mirror_limit);

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
      lr = lr + er * tr; lg = lg + eg * tg; lb = lb + eb * tb;
      tr = tr * cr; tg = tg * cg; tb = tb * cb;
    }
    if (mirror_live) {
      lr = lr + cr * mirror_tint; lg = lg + cg * mirror_tint; lb = lb + cb * mirror_tint;
    }
    float vx, vy, vz;
    if (diffuse) {
      vx = ux + nx * side; vy = uy + ny * side; vz = uz + nz * side;
    } else {
      vx = dx - 2.0f * dn * nx; vy = dy - 2.0f * dn * ny; vz = dz - 2.0f * dn * nz;
    }
    const float v_inv = 1.0f / sqrtf((vx * vx + vy * vy) + vz * vz);
    ox = ox + dx * t; oy = oy + dy * t; oz = oz + dz * t;
    dx = vx * v_inv; dy = vy * v_inv; dz = vz * v_inv;

    mh = mh_new;
    dc = dc + (diffuse ? 1 : 0);
    const bool alive = hit && !(mirror && mh_new >= mirror_limit) && dc < bounce_limit;
    if (!alive) break;
  }
  light[3 * i] = lr;
  light[3 * i + 1] = lg;
  light[3 * i + 2] = lb;
}

extern "C" int mm_trace_paths(const float* ori, const float* dirs,
                              const float* planes, int n_planes, int n_mode0,
                              int n_mode1, const int* seed, float* light,
                              int n_rays, int block_rays, int max_segments,
                              int bounce_limit, int mirror_limit,
                              float mirror_tint, float t_min, void* stream) {
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  const size_t smem = (size_t)n_planes * RECORD * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_rays > 0) {
    trace_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        ori, dirs, planes, n_planes, n_mode0, n_mode1, seed, light, n_rays,
        block_rays, max_segments, bounce_limit, mirror_limit, mirror_tint, t_min);
  }
  return (int)cudaGetLastError();
}
