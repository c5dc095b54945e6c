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
// one key, a data stride of 0 one data word. A live-id list (ids int32 [R],
// its count int32 [1] on the device; mm_threefry_rows) restricts a normal
// draw of R rows of ROW elements to the rows ids[0 .. count): element e' <
// ROW * count is row ids[e' / ROW]'s element e' % ROW, that is the full
// draw's element e = ROW * ids[e' / ROW] + e' % ROW, computed from e as the
// full draw computes it (a single key: c = e; per-row keys: m = e / ROW).
// Rows not on the list are left unwritten. Outputs:
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
// exact in float64). A native single-rounded fmaf, r = RN32(a * b + c),
// equals z unless the float64 sum is a float32 midpoint the exact sum missed
// (r odd) or a subnormal: rounding is monotone and every float32 midpoint is
// a float64 value. NORMAL's erf_inv sees only the 2^23 floats uniform gives
// on [nextafter(-1, 0), 1), and no step of erf_inv on any of them is such a
// case (tests/test_torch_prng_kernel.py checks every step of every one of
// them against prng.fma). ERFINV takes any input, and no step is such a case
// on any of the 2,130,706,434 float32 patterns of [-1, 1] either: the step
// check below counted every one of them on the card
// (tools/erf_inv_check.py). So both outputs take the native fmaf at every
// step; the float64 route stays as the reference of that check.
//
// Bound on the card: int32 issue for the hashing outputs, bytes for ERFINV
// (a read and a write of 4 bytes against 36-38 float32 FMAs). A hash is 79
// int32 operations (20 rounds of an add, a rotate and a xor; 17 adds of the
// key schedule, 2 xors for the third key word) for 4 or 16 bytes written; a
// normal adds 36-38 FMAs. A step rounded through float64 converts its
// running value float -> double -> float (two conversions at 16 a clock and
// SM against a native fmaf's one float32 instruction at 128), which set the
// time of the first versions of both outputs. Design: a grid-stride loop,
// keys and data read through the L1, no shared memory. A listed draw keeps
// the full draw's grid and template instance: a thread reads the count once
// (a near-empty list costs that read), and the list is a runtime operand, so
// the normal draw without one pays a uniform null test before the full
// loop; no other instance compiles the listed loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

// The hash and the uniform's arithmetic: threefry.cuh, shared with the
// frame setup and the camera rays.
using mm::threefry;
using mm::to_uniform;

constexpr int THREADS = 256;
// Elements a row of a listed draw: the normal triples of the segment loop.
constexpr unsigned ROW = 3;
enum Source { IOTA = 0, DATA32 = 1, DATA64 = 2, VALUES = 3 };
enum Output { PAIR = 0, XOR = 1, UNIFORM = 2, NORMAL = 3, ERFINV = 4 };

// prng.fma: RN32(RN64(a * b + c)), the product exact in float64 (see
// "Exactness" above), at erf_inv's STEPS FMA steps, numbered in the order the
// source evaluates them: _log_f32 0-9, log1p's rational 10-20 (den, then
// num), Giles' w < 5 polynomial 21-28 and w >= 5 polynomial 29-36. A route
// rounds every step one way:
//   NATIVE  a single-rounded fmaf, which equals prng.fma wherever the float64
//           sum is not a float32 midpoint the exact sum missed (nor
//           subnormal): the NORMAL and ERFINV outputs. It is exact on every
//           float32 in [-1, 1] (the step check, PERF.md §6), and every
//           |x| > 1 reaches the same steps with the same operands as x = +-1
//           (log_f32 clamps 1 - x^2 <= 0 to the smallest normal), so on any
//           non-NaN x;
//   FLOAT64 the float64 sum rounded (one float64 FMA and its conversions):
//           prng.fma itself, the reference of the step check.
enum Route { NATIVE = 0, FLOAT64 = 1 };
constexpr int STEPS = 37;

// Step S's FMA on route R. On FLOAT64 with `differ`, bit S is set where the
// native fmaf of the step's operands differs from the float64 result.
template <int R, int S>
__device__ __forceinline__ float fma_step(float a, float b, float c, unsigned long long* differ) {
  static_assert(S >= 0 && S < STEPS, "a step of erf_inv");
  if (R == NATIVE) return __fmaf_rn(a, b, c);
  const float z = __double2float_rn(__fma_rn((double)a, (double)b, (double)c));
  if (differ != nullptr && __float_as_uint(__fmaf_rn(a, b, c)) != __float_as_uint(z))
    *differ |= 1ull << S;
  return z;
}
#define MM_FMA(s, a, b, c) fma_step<R, s>((a), (b), (c), differ)

// prng._log_f32: XLA-CPU's float32 log for x > 0.
template <int R>
__device__ __forceinline__ float log_f32(float x, unsigned long long* differ) {
  x = x < 0x1p-126f ? 0x1p-126f : x;  // clamp_min to the smallest normal (NaN passes)
  const int bits = __float_as_int(x);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool low = m < 0x1.6a09e6p-1f;  // sqrt(1/2)
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  m = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float z = __fmul_rn(m, m);
  const float x3 = __fmul_rn(z, m);
  float y1 = MM_FMA(0, m, 0x1.204376p-4f, -0x1.d7a370p-4f);
  y1 = MM_FMA(1, y1, m, 0x1.de4a34p-4f);
  float y2 = MM_FMA(2, m, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  y2 = MM_FMA(3, y2, m, -0x1.555ca0p-3f);
  float y3 = MM_FMA(4, m, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y3 = MM_FMA(5, y3, m, 0x1.555554p-2f);
  float y = MM_FMA(6, y1, x3, y2);
  y = MM_FMA(7, y, x3, y3);
  y = MM_FMA(8, y, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  return MM_FMA(9, e, 0x1.63p-1f, __fadd_rn(__fsub_rn(m, __fmul_rn(z, 0.5f)), y));
}

// prng.log1p: XLA-CPU's float32 log1p, a rational function for
// |x| < sqrt(2) - 1, else log(1 + x).
template <int R>
__device__ __forceinline__ float log1p_xla(float x, unsigned long long* differ) {
  if (!(fabsf(x) < 0x1.a8279ap-2f)) return log_f32<R>(__fadd_rn(x, 1.0f), differ);
  const float x2 = __fmul_rn(x, x);
  float den = __fadd_rn(x, 0x1.e2035ap+3f);
  den = MM_FMA(10, den, x, 0x1.4c30b6p+6f);
  den = MM_FMA(11, den, x, 0x1.bb865ap+7f);
  den = MM_FMA(12, den, x, 0x1.351946p+8f);
  den = MM_FMA(13, den, x, 0x1.b0db14p+7f);
  den = MM_FMA(14, den, x, 0x1.e0f304p+5f);
  float num = 0x1.7bc096p-15f;
  num = MM_FMA(15, num, x, 0x1.fe818ap-2f);
  num = MM_FMA(16, num, x, 0x1.a509f4p+2f);
  num = MM_FMA(17, num, x, 0x1.de9738p+4f);
  num = MM_FMA(18, num, x, 0x1.e798ecp+5f);
  num = MM_FMA(19, num, x, 0x1.c8e75ap+5f);
  num = MM_FMA(20, num, x, 0x1.40a202p+4f);
  const float tail = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
  return __fadd_rn(x, __fadd_rn(__fmul_rn(x2, -0.5f), tail));
}

// prng.erf_inv: XLA's float32 erf_inv (Giles), for |x| <= 1.
template <int R>
__device__ __forceinline__ float erf_inv(float x, unsigned long long* differ = nullptr) {
  float w = -log1p_xla<R>(__fmul_rn(x, -x), differ);
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p;
  if (lt) {
    p = 0x1.e2cb10p-26f;
    p = MM_FMA(21, p, w, 0x1.70966cp-22f);
    p = MM_FMA(22, p, w, -0x1.d8e6aep-19f);
    p = MM_FMA(23, p, w, -0x1.26b582p-18f);
    p = MM_FMA(24, p, w, 0x1.ca65b6p-13f);
    p = MM_FMA(25, p, w, -0x1.48a810p-10f);
    p = MM_FMA(26, p, w, -0x1.11c9dep-8f);
    p = MM_FMA(27, p, w, 0x1.f91ec6p-3f);
    p = MM_FMA(28, p, w, 0x1.805c5ep+0f);
  } else {
    p = -0x1.a3e136p-13f;
    p = MM_FMA(29, p, w, 0x1.a76ad6p-14f);
    p = MM_FMA(30, p, w, 0x1.61b8e4p-10f);
    p = MM_FMA(31, p, w, -0x1.e17bcep-9f);
    p = MM_FMA(32, p, w, 0x1.7824f6p-8f);
    p = MM_FMA(33, p, w, -0x1.f38baep-8f);
    p = MM_FMA(34, p, w, 0x1.354afcp-7f);
    p = MM_FMA(35, p, w, 0x1.006db6p+0f);
    p = MM_FMA(36, p, w, 0x1.6a9efcp+1f);
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
  const int* ids;    // a live-id list, or null: every element
  const int* count;  // its count, on the device
};

// Element e of a draw: its key and count, the hash and the output.
template <int SRC, int OUT>
__device__ __forceinline__ void draw_element(const Args& a, unsigned long long e, bool narrow) {
  if (SRC == VALUES) {
    ((float*)a.out)[e] = erf_inv<NATIVE>(((const float*)a.data)[e * a.data_stride]);
    return;
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
    ((float*)a.out)[e] = __fmul_rn(erf_inv<NATIVE>(u), 0x1.6a09e6p+0f);
  }
}

template <int SRC, int OUT>
__global__ void __launch_bounds__(THREADS) threefry_kernel(Args a) {
  const unsigned long long step = (unsigned long long)gridDim.x * THREADS;
  const unsigned long long first = (unsigned long long)blockIdx.x * THREADS + threadIdx.x;
  const bool narrow = a.total <= 0xFFFFFFFFull;
  // Only the normal draw takes a live-id list: no other instance compiles
  // this loop. Element i of ROW * count is row ids[i / ROW]'s element
  // i % ROW (32-bit index arithmetic where the draw's counts fit 32 bits).
  if constexpr (SRC == IOTA && OUT == NORMAL) {
    if (a.ids != nullptr) {
      const unsigned long long listed = ROW * (unsigned long long)(unsigned)*a.count;
      const unsigned long long n = listed < a.total ? listed : a.total;
      for (unsigned long long i = first; i < n; i += step) {
        unsigned long long r, j;
        if (narrow) {
          r = (uint32_t)i / ROW;
          j = (uint32_t)i - (uint32_t)r * ROW;
        } else {
          r = i / ROW;
          j = i - r * ROW;
        }
        draw_element<SRC, OUT>(a, ROW * (unsigned long long)(unsigned)a.ids[r] + j, narrow);
      }
      return;
    }
  }
  for (unsigned long long e = first; e < a.total; e += step) draw_element<SRC, OUT>(a, e, narrow);
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

// The step check (mm_erf_inv_steps): erf_inv of the float32 patterns
// first + e * stride, e < count, on the FLOAT64 route with every step's
// native fmaf compared on the same operands. counts[s] gains the patterns at
// which step s's native fmaf differs; counts[STEPS] those whose NATIVE result
// (the outputs' route) differs from the FLOAT64 one.
__global__ void __launch_bounds__(THREADS)
    erf_inv_steps_kernel(uint32_t first, uint32_t stride, unsigned long long count,
                         unsigned long long* counts) {
  const unsigned long long step = (unsigned long long)gridDim.x * THREADS;
  for (unsigned long long e = (unsigned long long)blockIdx.x * THREADS + threadIdx.x; e < count;
       e += step) {
    const float x = __uint_as_float(first + (uint32_t)e * stride);
    unsigned long long differ = 0;
    const float z = erf_inv<FLOAT64>(x, &differ);
    if (__float_as_uint(erf_inv<NATIVE>(x)) != __float_as_uint(z)) differ |= 1ull << STEPS;
    while (differ != 0) {
      atomicAdd(counts + (__ffsll((long long)differ) - 1), 1ull);
      differ &= differ - 1;
    }
  }
}

}  // namespace

// The step check over `count` patterns from `first` by `stride` (no pattern
// wraps past 2^32); counts: [STEPS + 1], zeroed by the caller.
extern "C" int mm_erf_inv_steps(unsigned int first, unsigned int stride, unsigned long long count,
                                unsigned long long* counts, void* stream) {
  if (counts == nullptr || (count > 0 && (unsigned long long)first +
                                              (count - 1) * (unsigned long long)stride >
                                              0xFFFFFFFFull))
    return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaGetLastError();
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const unsigned long long need = (count + THREADS - 1) / THREADS;
  const unsigned long long most = (unsigned long long)(sms > 0 ? sms : 1) * 16;
  erf_inv_steps_kernel<<<(unsigned)(need < most ? need : most), THREADS, 0,
                         (cudaStream_t)stream>>>(first, stride, count, counts);
  return (int)cudaGetLastError();
}

namespace {

int draw(const long long* keys, long long key_stride, int source, int output, const void* data,
         long long data_stride, unsigned int data_imm, unsigned long long per_key,
         unsigned long long total, float lo, float hi, void* out, const int* ids,
         const int* count, void* stream) {
  if (total == 0) return (int)cudaGetLastError();
  if (out == nullptr || (source != VALUES && keys == nullptr) ||
      (source == IOTA && (per_key == 0 || per_key > 0xFFFFFFFFull || total % per_key)) ||
      (source == VALUES && data == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{keys, key_stride, data, data_stride, data_imm, per_key, total, lo, hi, out,
               ids, count};
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

}  // namespace

// source / output as the enums above; the pairs that exist: IOTA with PAIR,
// XOR, UNIFORM or NORMAL; DATA32 / DATA64 with PAIR; VALUES with ERFINV.
extern "C" int mm_threefry(const long long* keys, long long key_stride, int source,
                           int output, const void* data, long long data_stride,
                           unsigned int data_imm, unsigned long long per_key,
                           unsigned long long total, float lo, float hi, void* out,
                           void* stream) {
  return draw(keys, key_stride, source, output, data, data_stride, data_imm, per_key, total, lo,
              hi, out, nullptr, nullptr, stream);
}

// mm_threefry's normal draw (IOTA, NORMAL) of total / ROW rows, drawn at
// the rows of the live-id list (ids, count) alone: the same launch and grid,
// each listed row bitwise the full draw's.
extern "C" int mm_threefry_rows(const long long* keys, long long key_stride, int source,
                                int output, const void* data, long long data_stride,
                                unsigned int data_imm, unsigned long long per_key,
                                unsigned long long total, float lo, float hi, void* out,
                                const int* ids, const int* count, void* stream) {
  if (source != IOTA || output != NORMAL || ids == nullptr || count == nullptr || total % ROW)
    return (int)cudaErrorInvalidValue;
  return draw(keys, key_stride, source, output, data, data_stride, data_imm, per_key, total, lo,
              hi, out, ids, count, stream);
}
