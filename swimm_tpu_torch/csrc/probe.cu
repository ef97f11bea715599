// Two measurement kernels. Neither scores anything: each exists to be timed
// (swimm_tpu_torch/benchmarks/roofline.py and probe_narrow_int.py), so each
// is simple and exact, not fast.
//
//   chain_kernel_<form>   replaces benchmarks/roofline.py vpu_kernel (via
//                         measure_vpu_ops_per_sec): one thread per element
//                         runs CHAINS independent chains v <- max(v + 1,
//                         2000 - v), started at x + 17 s, UNROLL steps a
//                         loop iteration, `loops` iterations, and writes the
//                         maximum over its chains. Three forms compute the
//                         same function:
//                           f32        the TPU kernel's own (FADD, FADD,
//                                      FMNMX a step);
//                           viaddmnmx  in int32, __viaddmax_s32(v, 1,
//                                      2000 - v): an IADD and a VIADDMNMX;
//                           vimnmx3    the viaddmnmx chains, and a running
//                                      maximum over each pair of them,
//                                      m = __vimax3_s32(m, v_a, v_b) after
//                                      every step: the walk's own use of
//                                      VIMNMX3 (sw_walk_hg.cuh, two rows
//                                      per instruction). A chain grows at
//                                      every step (max(v + 1, 2000 - v) >
//                                      v), so the running maximum is the
//                                      maximum of the last values: the same
//                                      function.
//                         VIADDMNMX and VIMNMX3 are the two instructions of
//                         the search walk (sw_walk_hg.cuh) counted as half
//                         rate; the int32 forms measure how fast the card
//                         issues them, the f32 form a full-rate mix. The
//                         first vimnmx3 form, __vimax3_s32(v + 1, 2000 - v,
//                         c), issued no VIMNMX3 at all: ptxas fused the
//                         addition into a VIADDMNMX and kept a two-input
//                         VIMNMX for c.
//   narrow_kernel_<type>  replaces benchmarks/probe_narrow_int.py body (via
//                         _try_kernel): h = max(max(a + a, a - lo),
//                         max(a, lo)); o = max(h - a, lo), elementwise,
//                         chained `steps` times in registers (the TPU
//                         function is a lax.scan of 8 pallas_calls: one
//                         launch of 8 steps here). One thread per 32-bit
//                         word:
//                           i32    one lane, lo = -1000, on the walk's
//                                  instructions (__viaddmax_s32,
//                                  __vimax3_s32);
//                           i16x2  two lanes, lo = -120 (__vadd2, __vsub2,
//                                  __viaddmax_s16x2, __vimax3_s16x2,
//                                  __vmaxs2);
//                           i8x4   four lanes, lo = -120 (__vadd4, __vsub4,
//                                  __vmaxs4).
//                         The arithmetic wraps, as JAX's and torch's integer
//                         types do: in int8, a - lo = a + 120 wraps for every
//                         a >= 8, and a + a wraps once a chain settles at
//                         120. The saturating forms (__vaddss2, __vsubss4,
//                         ...) would give other answers. C++ additions are
//                         done on unsigned values, where wrapping is defined.
//
// What bounds them on the card: instruction issue. Each thread reads one
// element and writes one; between the two it runs thousands of dependent
// steps on CHAINS (P1) or one (P2) chains, and enough threads are resident
// to hide each instruction's latency. Both step loops are written out by
// hand (UNROLL steps of every chain, or 8 narrow steps, under
// `#pragma unroll 1`) so that the loop in the SASS holds a known number of
// steps and its instructions can be counted per step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;    // independent chains per element (STREAMS)
constexpr int UNROLL = 8;    // steps of every chain per loop iteration
constexpr int THREADS = 256;
constexpr int NARROW_UNROLL = 8;

enum Form { kF32 = 0, kViaddmnmx = 1, kVimnmx3 = 2 };

// One step of a chain, per form.
template <int FORM>
struct ChainStep;

template <>
struct ChainStep<kF32> {
  static __device__ __forceinline__ float step(float v) {
    return fmaxf(v + 1.0f, 2000.0f - v);
  }
};

template <>
struct ChainStep<kViaddmnmx> {
  static __device__ __forceinline__ int step(int v) {
    const int down = static_cast<int>(2000u - static_cast<unsigned>(v));
    return __viaddmax_s32(v, 1, down);
  }
};

template <int FORM, typename T>
__device__ __forceinline__ void chains(const T* __restrict__ x,
                                       T* __restrict__ out, int64_t n,
                                       int loops) {
  constexpr int STEP_FORM = FORM == kVimnmx3 ? kViaddmnmx : FORM;
  constexpr bool running = FORM == kVimnmx3;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  T v[CHAINS];
  T m[CHAINS / 2];   // the running maxima of the vimnmx3 form
#pragma unroll
  for (int s = 0; s < CHAINS; ++s) v[s] = x[i] + static_cast<T>(17 * s);
#pragma unroll
  for (int p = 0; p < CHAINS / 2; ++p) m[p] = max(v[2 * p], v[2 * p + 1]);
#pragma unroll 1
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int s = 0; s < CHAINS; ++s) {
        v[s] = ChainStep<STEP_FORM>::step(v[s]);
      }
      if constexpr (running) {
#pragma unroll
        for (int p = 0; p < CHAINS / 2; ++p) {
          m[p] = __vimax3_s32(m[p], v[2 * p], v[2 * p + 1]);
        }
      }
    }
  }
  T acc = running ? m[0] : v[0];
#pragma unroll
  for (int s = 1; s < (running ? CHAINS / 2 : CHAINS); ++s) {
    const T w = running ? m[s] : v[s];
    acc = acc > w ? acc : w;
  }
  out[i] = acc;
}

// One step of the narrow probe on one 32-bit word, per lane type.
struct NarrowI32 {
  static __device__ __forceinline__ uint32_t step(uint32_t w) {
    const int a = static_cast<int>(w);
    const int a_lo = static_cast<int>(w + 1000u);      // a - lo
    const int t = __viaddmax_s32(a, a, a_lo);          // max(a + a, a - lo)
    const int h = __vimax3_s32(t, a, -1000);           // max(t, a, lo)
    const int neg_a = static_cast<int>(0u - w);
    return static_cast<uint32_t>(
        __viaddmax_s32(h, neg_a, -1000));              // max(h - a, lo)
  }
};

struct NarrowI16x2 {
  static __device__ __forceinline__ uint32_t step(uint32_t w) {
    constexpr uint32_t kLo = 0xFF88FF88u;       // -120 in each half
    constexpr uint32_t kMinusLo = 0x00780078u;  // +120 in each half
    const uint32_t a_lo = __vadd2(w, kMinusLo);         // a - lo
    const uint32_t t = __viaddmax_s16x2(w, w, a_lo);    // max(a + a, a - lo)
    const uint32_t h = __vimax3_s16x2(t, w, kLo);       // max(t, a, lo)
    return __vmaxs2(__vsub2(h, w), kLo);                // max(h - a, lo)
  }
};

struct NarrowI8x4 {
  static __device__ __forceinline__ uint32_t step(uint32_t w) {
    constexpr uint32_t kLo = 0x88888888u;       // -120 in each byte
    constexpr uint32_t kMinusLo = 0x78787878u;  // +120 in each byte
    const uint32_t a_lo = __vadd4(w, kMinusLo);         // a - lo
    const uint32_t t = __vmaxs4(__vadd4(w, w), a_lo);   // max(a + a, a - lo)
    const uint32_t h = __vmaxs4(t, __vmaxs4(w, kLo));   // max(t, max(a, lo))
    return __vmaxs4(__vsub4(h, w), kLo);                // max(h - a, lo)
  }
};

template <typename Lanes>
__device__ __forceinline__ void narrow(const uint32_t* __restrict__ x,
                                       uint32_t* __restrict__ out,
                                       int64_t n_words, int steps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n_words) return;
  uint32_t w = x[i];
  int k = 0;
#pragma unroll 1
  for (; k + NARROW_UNROLL <= steps; k += NARROW_UNROLL) {
#pragma unroll
    for (int u = 0; u < NARROW_UNROLL; ++u) w = Lanes::step(w);
  }
#pragma unroll 1
  for (; k < steps; ++k) w = Lanes::step(w);
  out[i] = w;
}

int blocks_for(int64_t n) {
  return static_cast<int>((n + THREADS - 1) / THREADS);
}

}  // namespace

// Unmangled names, so that the SASS of each form can be found and counted
// (benchmarks/roofline.py sass_per_step).
extern "C" __global__ void __launch_bounds__(THREADS, 8)
chain_kernel_f32(const float* __restrict__ x, float* __restrict__ out,
                 int64_t n, int loops) {
  chains<kF32>(x, out, n, loops);
}

extern "C" __global__ void __launch_bounds__(THREADS, 8)
chain_kernel_viaddmnmx(const int* __restrict__ x, int* __restrict__ out,
                       int64_t n, int loops) {
  chains<kViaddmnmx>(x, out, n, loops);
}

extern "C" __global__ void __launch_bounds__(THREADS, 8)
chain_kernel_vimnmx3(const int* __restrict__ x, int* __restrict__ out,
                     int64_t n, int loops) {
  chains<kVimnmx3>(x, out, n, loops);
}

extern "C" __global__ void __launch_bounds__(THREADS, 8)
narrow_kernel_i32(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  int64_t n_words, int steps) {
  narrow<NarrowI32>(x, out, n_words, steps);
}

extern "C" __global__ void __launch_bounds__(THREADS, 8)
narrow_kernel_i16x2(const uint32_t* __restrict__ x,
                    uint32_t* __restrict__ out, int64_t n_words, int steps) {
  narrow<NarrowI16x2>(x, out, n_words, steps);
}

extern "C" __global__ void __launch_bounds__(THREADS, 8)
narrow_kernel_i8x4(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   int64_t n_words, int steps) {
  narrow<NarrowI8x4>(x, out, n_words, steps);
}

// form: 0 f32 (x, out float32), 1 viaddmnmx, 2 vimnmx3 (x, out int32).
extern "C" int chain_launch(const void* x, void* out, long long n, int loops,
                            int form, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (loops < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(n);
  switch (form) {
    case kF32:
      chain_kernel_f32<<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), n, loops);
      break;
    case kViaddmnmx:
      chain_kernel_viaddmnmx<<<grid, THREADS, 0, s>>>(
          static_cast<const int*>(x), static_cast<int*>(out), n, loops);
      break;
    case kVimnmx3:
      chain_kernel_vimnmx3<<<grid, THREADS, 0, s>>>(
          static_cast<const int*>(x), static_cast<int*>(out), n, loops);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// bits: 32, 16 or 8, the lane width inside each 32-bit word.
extern "C" int narrow_launch(const void* x, void* out, long long n_words,
                             int steps, int bits, void* stream) {
  if (n_words <= 0) return static_cast<int>(cudaGetLastError());
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(n_words);
  const uint32_t* in = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (bits) {
    case 32:
      narrow_kernel_i32<<<grid, THREADS, 0, s>>>(in, o, n_words, steps);
      break;
    case 16:
      narrow_kernel_i16x2<<<grid, THREADS, 0, s>>>(in, o, n_words, steps);
      break;
    case 8:
      narrow_kernel_i8x4<<<grid, THREADS, 0, s>>>(in, o, n_words, steps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
