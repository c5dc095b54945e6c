// Threefry-2x32: jax.random's counter-based draws (split, fold_in,
// random_bits, uniform, normal) in one launch each, one thread an output
// element.
//
// Replaces no Pallas kernel: the JAX package draws through jax.random, which
// XLA compiles under jit into one fused loop per draw (render/pipeline.py:68,
// 85-86, 117; runtime/step.py:112, 120, 182; ops/sampling.py:25, 34;
// render/tracer.py:73, 192-194, 233-240). Its plain version is the port's
// ops/prng.py (*_plain), which is bit-exact with jax.random under
// jax_threefry_partitionable=True: a draw of n words hashes the 64-bit iota
// (x0, x1) = (0, c), c in [0, n), and a 32-bit word is b1 ^ b2.
//
// One kernel template over output elements e in [0, total):
//   source IOTA:   key m = e / per_key, count c = e % per_key; x = (0, c)
//                  (split, random_bits and the draws built on them, one key
//                  or a key batch [M, 2], M = total / per_key);
//   source DATA:   key m = e, x = (0, data[e] & 0xFFFFFFFF), data int32 or
//                  int64 (fold_in; data null = one value for every key);
//   source VALUES: no hash: the float32 values[e] go straight to erf_inv.
// Keys are int64 [M, 2] holding uint32 words; a key stride of 0 broadcasts
// one key, a data stride of 0 one data word. Outputs:
//   PAIR    (b1, b2) as int64 [total, 2], the port's key layout;
//   XOR     b1 ^ b2 as int64 [total];
//   UNIFORM float32 in [lo, hi): 23 bits under exponent 0, minus one, times
//           (hi - lo) rounded in f32, plus lo, then max(lo, .);
//   NORMAL  sqrt(2) * erf_inv(UNIFORM on [nextafter(-1, 0), 1));
//   ERFINV  erf_inv(values[e]) (source VALUES).
//
// Exactness (built with -fmad=false, IEEE division and square root, no flush
// of denormals, as every kernel of the port): every float32 step of
// prng.py's uniform, log1p, _log_f32 and erf_inv is its own __f*_rn
// operation in the same order, and each prng.fma is the plain version's
// double rounding z = RN32(RN64(a * b + c)) (the product of two float32 is
// exact in float64). ERFINV takes any input, so its fma64 rounds the sum of
// one float64 FMA. NORMAL's erf_inv sees only the 2^23 floats uniform gives
// on [nextafter(-1, 0), 1), and its fma64 is a native single-rounded fmaf,
// r = RN32(a * b + c): rounding is monotone and every float32 midpoint is a
// float64 value, so r == z unless the float64 sum is a float32 midpoint the
// exact sum missed (r odd) or a subnormal, and no step of erf_inv on any of
// those 2^23 values is (tests/test_torch_prng_kernel.py checks every step
// of every one of them against prng.fma).
//
// Bound on the card: int32 issue, not bytes. A hash is 79 int32 operations
// (20 rounds of an add, a rotate and a xor; 17 adds of the key schedule, 2
// xors for the third key word) for 4 or 16 bytes written; a normal adds 36-38
// emulated FMAs. Rounded through float64, each converted its running value
// float -> double -> float (~77 conversions a normal at 16 a clock and SM),
// which set the time of a normal and of an erf_inv; a native fmaf is one
// float32 instruction. Design: a grid-stride loop, keys and data read
// through the L1, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

// The hash and the uniform's arithmetic: threefry.cuh, shared with the
// frame setup and the camera rays.
using mm::threefry;
using mm::to_uniform;

constexpr int THREADS = 256;
enum Source { IOTA = 0, DATA32 = 1, DATA64 = 2, VALUES = 3 };
enum Output { PAIR = 0, XOR = 1, UNIFORM = 2, NORMAL = 3, ERFINV = 4 };

// prng.fma: RN32(RN64(a * b + c)), the product exact in float64 (see
// "Exactness" above). EXACT rounds the float64 sum, for any input; the
// native form is a single-rounded fmaf, which equals it wherever the float64
// sum is not a float32 midpoint the exact sum missed (nor subnormal): on
// every value a normal draw gives, but not on every input.
template <bool EXACT>
__device__ __forceinline__ float fma64(float a, float b, float c) {
  if (EXACT) return __double2float_rn(__fma_rn((double)a, (double)b, (double)c));
  return __fmaf_rn(a, b, c);
}
#define MM_FMA(a, b, c) fma64<EXACT>((a), (b), (c))

// prng._log_f32: XLA-CPU's float32 log for x > 0.
template <bool EXACT>
__device__ __forceinline__ float log_f32(float x) {
  x = x < 0x1p-126f ? 0x1p-126f : x;  // clamp_min to the smallest normal (NaN passes)
  const int bits = __float_as_int(x);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool low = m < 0x1.6a09e6p-1f;  // sqrt(1/2)
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  m = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float z = __fmul_rn(m, m);
  const float x3 = __fmul_rn(z, m);
  const float y1 = MM_FMA(MM_FMA(m, 0x1.204376p-4f, -0x1.d7a370p-4f), m, 0x1.de4a34p-4f);
  const float y2 = MM_FMA(MM_FMA(m, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), m, -0x1.555ca0p-3f);
  const float y3 = MM_FMA(MM_FMA(m, 0x1.999d58p-3f, -0x1.fffff8p-3f), m, 0x1.555554p-2f);
  float y = MM_FMA(MM_FMA(y1, x3, y2), x3, y3);
  y = MM_FMA(y, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  return MM_FMA(e, 0x1.63p-1f, __fadd_rn(__fsub_rn(m, __fmul_rn(z, 0.5f)), y));
}

// prng.log1p: XLA-CPU's float32 log1p, a rational function for
// |x| < sqrt(2) - 1, else log(1 + x).
template <bool EXACT>
__device__ __forceinline__ float log1p_xla(float x) {
  if (!(fabsf(x) < 0x1.a8279ap-2f)) return log_f32<EXACT>(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float den = __fadd_rn(x, 0x1.e2035ap+3f);
  den = MM_FMA(den, x, 0x1.4c30b6p+6f);
  den = MM_FMA(den, x, 0x1.bb865ap+7f);
  den = MM_FMA(den, x, 0x1.351946p+8f);
  den = MM_FMA(den, x, 0x1.b0db14p+7f);
  den = MM_FMA(den, x, 0x1.e0f304p+5f);
  float num = 0x1.7bc096p-15f;
  num = MM_FMA(num, x, 0x1.fe818ap-2f);
  num = MM_FMA(num, x, 0x1.a509f4p+2f);
  num = MM_FMA(num, x, 0x1.de9738p+4f);
  num = MM_FMA(num, x, 0x1.e798ecp+5f);
  num = MM_FMA(num, x, 0x1.c8e75ap+5f);
  num = MM_FMA(num, x, 0x1.40a202p+4f);
  const float tail = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
  return __fadd_rn(x, __fadd_rn(__fmul_rn(x2, -0.5f), tail));
}

// prng.erf_inv: XLA's float32 erf_inv (Giles), for |x| <= 1; EXACT for
// any input, native on the uniforms of a normal draw.
template <bool EXACT>
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1p_xla<EXACT>(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p;
  if (lt) {
    p = 0x1.e2cb10p-26f;
    p = MM_FMA(p, w, 0x1.70966cp-22f);
    p = MM_FMA(p, w, -0x1.d8e6aep-19f);
    p = MM_FMA(p, w, -0x1.26b582p-18f);
    p = MM_FMA(p, w, 0x1.ca65b6p-13f);
    p = MM_FMA(p, w, -0x1.48a810p-10f);
    p = MM_FMA(p, w, -0x1.11c9dep-8f);
    p = MM_FMA(p, w, 0x1.f91ec6p-3f);
    p = MM_FMA(p, w, 0x1.805c5ep+0f);
  } else {
    p = -0x1.a3e136p-13f;
    p = MM_FMA(p, w, 0x1.a76ad6p-14f);
    p = MM_FMA(p, w, 0x1.61b8e4p-10f);
    p = MM_FMA(p, w, -0x1.e17bcep-9f);
    p = MM_FMA(p, w, 0x1.7824f6p-8f);
    p = MM_FMA(p, w, -0x1.f38baep-8f);
    p = MM_FMA(p, w, 0x1.354afcp-7f);
    p = MM_FMA(p, w, 0x1.006db6p+0f);
    p = MM_FMA(p, w, 0x1.6a9efcp+1f);
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
}
#undef MM_FMA

struct Args {
  const long long* keys;
  long long key_stride;   // in keys: 0 broadcasts one key
  const void* data;       // DATA32 / DATA64 words, VALUES floats; null = data_imm
  long long data_stride;  // in elements: 0 broadcasts one word
  uint32_t data_imm;
  unsigned long long per_key;  // IOTA: counts a key
  unsigned long long total;
  float lo, hi;
  void* out;
};

template <int SRC, int OUT>
__global__ void __launch_bounds__(THREADS) threefry_kernel(Args a) {
  const unsigned long long step = (unsigned long long)gridDim.x * THREADS;
  const bool narrow = a.total <= 0xFFFFFFFFull;
  for (unsigned long long e = (unsigned long long)blockIdx.x * THREADS + threadIdx.x;
       e < a.total; e += step) {
    if (SRC == VALUES) {
      ((float*)a.out)[e] = erf_inv<true>(((const float*)a.data)[e * a.data_stride]);
      continue;
    }
    unsigned long long m;
    uint32_t x1;
    if (SRC == IOTA) {
      if (a.per_key == a.total) {
        m = 0;
        x1 = (uint32_t)e;
      } else if (narrow) {
        const uint32_t q = (uint32_t)e / (uint32_t)a.per_key;
        m = q;
        x1 = (uint32_t)e - q * (uint32_t)a.per_key;
      } else {
        m = e / a.per_key;
        x1 = (uint32_t)(e - m * a.per_key);
      }
    } else {
      m = e;
      if (a.data == nullptr)
        x1 = a.data_imm;
      else if (SRC == DATA32)
        x1 = (uint32_t)((const int*)a.data)[e * a.data_stride];
      else
        x1 = (uint32_t)((const long long*)a.data)[e * a.data_stride];
    }
    const long long* k = a.keys + 2 * (m * a.key_stride);
    uint32_t x0 = 0;
    threefry((uint32_t)k[0], (uint32_t)k[1], x0, x1);
    if (OUT == PAIR) {
      ((longlong2*)a.out)[e] = make_longlong2((long long)x0, (long long)x1);
    } else if (OUT == XOR) {
      ((long long*)a.out)[e] = (long long)(x0 ^ x1);
    } else if (OUT == UNIFORM) {
      ((float*)a.out)[e] = to_uniform(x0 ^ x1, a.lo, a.hi);
    } else if (OUT == NORMAL) {
      // nextafter(-1, 0) and sqrt(2) in float32
      const float u = to_uniform(x0 ^ x1, -0x1.fffffep-1f, 1.0f);
      ((float*)a.out)[e] = __fmul_rn(erf_inv<false>(u), 0x1.6a09e6p+0f);
    }
  }
}

template <int SRC, int OUT>
int launch(const Args& a, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const unsigned long long need = (a.total + THREADS - 1) / THREADS;
  const unsigned long long most = (unsigned long long)(sms > 0 ? sms : 1) * 16;
  const unsigned blocks = (unsigned)(need < most ? need : most);
  threefry_kernel<SRC, OUT><<<blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// source / output as the enums above; the pairs that exist: IOTA with PAIR,
// XOR, UNIFORM or NORMAL; DATA32 / DATA64 with PAIR; VALUES with ERFINV.
extern "C" int mm_threefry(const long long* keys, long long key_stride, int source,
                           int output, const void* data, long long data_stride,
                           unsigned int data_imm, unsigned long long per_key,
                           unsigned long long total, float lo, float hi, void* out,
                           void* stream) {
  if (total == 0) return (int)cudaGetLastError();
  if (out == nullptr || (source != VALUES && keys == nullptr) ||
      (source == IOTA && (per_key == 0 || per_key > 0xFFFFFFFFull || total % per_key)) ||
      (source == VALUES && data == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{keys, key_stride, data, data_stride, data_imm, per_key, total, lo, hi, out};
  const cudaStream_t s = (cudaStream_t)stream;
  if (source == IOTA) {
    switch (output) {
      case PAIR: return launch<IOTA, PAIR>(a, s);
      case XOR: return launch<IOTA, XOR>(a, s);
      case UNIFORM: return launch<IOTA, UNIFORM>(a, s);
      case NORMAL: return launch<IOTA, NORMAL>(a, s);
    }
  } else if (source == DATA32 && output == PAIR) {
    return launch<DATA32, PAIR>(a, s);
  } else if (source == DATA64 && output == PAIR) {
    return launch<DATA64, PAIR>(a, s);
  } else if (source == VALUES && output == ERFINV) {
    return launch<VALUES, ERFINV>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
