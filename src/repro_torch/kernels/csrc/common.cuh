// Shared pieces of the boundary kernels (coach_kernels.cu, row_pass.cuh,
// uaq_quantize.cu, semantic_probe.cu): element types, warp reductions, a
// row's NaN-carrying min / max and its UAQ parameters (K1 and K3), the
// UAQ rounding of one value, the probe's top-2 (K1 and K4), and the fused
// boundary kernel's entry points.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes of the entry points (kernels/_build.py DTYPE_CODES)
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Arguments of the fused boundary row pass (K1: quantize + GAP + probe).
struct RowArgs {
  const void* x;
  void *payload, *scale, *zp, *ws, *counters;
  const void* centers;
  void *feat, *sep, *best, *sims;
  int B, S, D, L, rows_per_cta, wpr;
};

// One per activation type and load width (16-byte vectors, or single
// elements for odd widths and unaligned rows), each in its own
// translation unit row_pass_*.cu, so that nvcc builds them in parallel.
#define COACH_ROWS(name) \
  cudaError_t name(const RowArgs& a, int bits, cudaStream_t st)
COACH_ROWS(coach_rows_f32);
COACH_ROWS(coach_rows_bf16);
COACH_ROWS(coach_rows_f16);
COACH_ROWS(coach_rows_f32_scalar);
COACH_ROWS(coach_rows_bf16_scalar);
COACH_ROWS(coach_rows_f16_scalar);

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------ NaN-carrying min / max
// min.NaN / max.NaN return NaN when either operand is NaN, as torch.amin /
// torch.amax (and jnp.min / jnp.max) carry a NaN; fminf / fmaxf drop it.
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// ascending floats -> ascending unsigned keys (-0.0 below +0.0), and back
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float funkey(unsigned k) {
  return __uint_as_float(k ^ ((int)k < 0 ? 0x80000000u : 0xffffffffu));
}

// A row's min and max as keys, and whether it holds a NaN.
struct MinMaxKeys {
  unsigned nan, lo, hi;
};

// From each lane's lo / hi (taken with fmin_nan / fmax_nan: NaN if the
// lane saw one; +inf / -inf if it saw nothing), across the warp: one
// redux.sync each, no shuffle tree.
__device__ __forceinline__ MinMaxKeys warp_minmax(float lo, float hi) {
  MinMaxKeys k;
  k.nan = __reduce_or_sync(kFull, (unsigned)(lo != lo));
  k.lo = __reduce_min_sync(kFull, fkey(lo));
  k.hi = __reduce_max_sync(kFull, fkey(hi));
  return k;
}

// Combine the keys of two parts of one row (exact: min / max / or).
__device__ __forceinline__ void merge_minmax(MinMaxKeys& a,
                                             const MinMaxKeys& b) {
  a.nan |= b.nan;
  a.lo = min(a.lo, b.lo);
  a.hi = max(a.hi, b.hi);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Barrier over the `n` threads of one warp group (id 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// ------------------------------------------------ element types
// Widen one element, or one 16-byte vector (4 float32 or 8 16-bit
// values, element 0 in the low bits), to float32; narrow with
// round-to-nearest-even.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static float widen(float v) { return v; }
  __device__ static void widen16(uint4 u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
  __device__ static float narrow(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static void widen16(uint4 u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct Elem<__half> {
  static constexpr int kVec = 8;
  __device__ static float widen(__half v) { return __half2float(v); }
  __device__ static void widen16(uint4 u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      o[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
  __device__ static __half narrow(float v) { return __float2half_rn(v); }
};

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

__device__ __forceinline__ uint32_t bits16(__half v) {
  return __half_as_ushort(v);
}

// Write U float32 values as U elements of T at `dst` (16-byte aligned
// when U * sizeof(T) >= 16, else U * sizeof(T)-aligned).
template <typename T, int U>
__device__ __forceinline__ void store_vals(T* dst, const float* v) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < U; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
    uint32_t w[U / 2];
#pragma unroll
    for (int i = 0; i < U / 2; ++i)
      w[i] = bits16(Elem<T>::narrow(v[2 * i])) |
             (bits16(Elem<T>::narrow(v[2 * i + 1])) << 16);
    if constexpr (U == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// ------------------------------------------------ quantize
// q = clamp(rint(v / sc + z), 0, qmax), rounding half to even.  v / sc
// is taken from r = RN(1 / sc), the row's correctly rounded reciprocal:
// q0 = RN(v * r) is within 1.5 ulp of v / sc, one step
// q1 = RN(q0 + (v - sc * q0) * r) (remainder exact by FMA) brings it
// within about half an ulp, and a second step gives the correctly rounded
// quotient (Markstein's theorem: r within half an ulp of 1 / sc and the
// estimate within an ulp of v / sc), so the same bits as __fdiv_rn in
// five instructions and no branch.  FAST is false for a row where v * r
// could overflow; it then takes __fdiv_rn.  The conversion rounds half to
// even and clamps below at 0 (float to unsigned saturates; NaN gives 0).
template <int BITS, bool FAST>
__device__ __forceinline__ uint32_t quant1(float v, float sc, float r,
                                           float z) {
  float t;
  if constexpr (FAST) {
    const float q0 = __fmul_rn(v, r);
    const float q1 = __fmaf_rn(__fmaf_rn(-q0, sc, v), r, q0);
    t = __fmaf_rn(__fmaf_rn(-q1, sc, v), r, q1);
  } else {
    t = __fdiv_rn(v, sc);
  }
  return min(__float2uint_rn(__fadd_rn(t, z)), (1u << BITS) - 1u);
}

// A row's quantization parameters from its min / max keys: a row that
// holds a NaN gets NaN scale and zp (so every code 0), as the plain
// version does; otherwise
//   scale = fmaxf(hi - lo, 1e-8) * (1 / qmax)   (float32 reciprocal)
//   zp    = rint(-lo / scale)
// and r = RN(1 / scale) for quant1, `fast` where v * r cannot overflow.
struct RowQ {
  float sc, z, r;
  bool fast;
};

template <int BITS>
__device__ __forceinline__ RowQ row_qparams(const MinMaxKeys& k) {
  const float lo = funkey(k.lo), hi = funkey(k.hi);
  // 1 / qmax rounded to float32 (the constant is folded in IEEE
  // round-to-nearest, the bits of __fdiv_rn)
  constexpr float inv_qmax = 1.0f / float((1 << BITS) - 1);
  RowQ p;
  p.sc = k.nan ? __int_as_float(0x7fffffff)
               : __fmul_rn(fmaxf(__fsub_rn(hi, lo), 1e-8f), inv_qmax);
  p.z = rintf(__fdiv_rn(-lo, p.sc));
  p.r = __frcp_rn(p.sc);
  p.fast = __fmul_rn(fmaxf(fabsf(lo), fabsf(hi)), p.r) < 1e30f;
  return p;
}

// ------------------------------------------------ probe top-2
// A sim's key in torch.argmax's order: a NaN above every number (fkey
// orders the numbers, -0.0 below +0.0); 0 is below every key.
__device__ __forceinline__ unsigned sim_key(float v) {
  return v != v ? 0xffffffffu : fkey(v);
}

__device__ __forceinline__ float sim_of_key(unsigned k) {
  return k == 0xffffffffu ? __int_as_float(0x7fffffff) : funkey(k);
}

// Run by one whole warp over the sims sl[0, L): top-1 as torch.argmax
// picks it (the first NaN, else the first index of the largest), t_h the
// sims' max and t_sh the max of the others, both as torch.amax takes
// them (NaN if one is NaN; t_sh -inf when L == 1), then Eq. 9
//   sep = |sims| (t_h - t_sh) t_h / max(t_sh, 1e-12);
// lane 0 writes sep and best.  Each lane keeps the best and second-best
// key of its sims; three redux.sync then give the max key, the first
// index holding it, and t_sh (the other lanes' best, or the owner's
// second best).
__device__ __forceinline__ void probe_top2(const float* sl, int L,
                                           float* sep, int* best) {
  const int lane = threadIdx.x & 31;
  unsigned kb = 0u, k2 = fkey(-INFINITY);
  int bi = L;
  float nrm = 0.f;
  for (int l = lane; l < L; l += 32) {
    const float v = sl[l];
    const unsigned k = sim_key(v);
    if (k > kb) {
      k2 = max(k2, kb);
      kb = k;
      bi = l;
    } else {
      k2 = max(k2, k);
    }
    nrm = __fmaf_rn(v, v, nrm);
  }
  const unsigned kmax = __reduce_max_sync(kFull, kb);
  const int b = (int)__reduce_min_sync(
      kFull, kb == kmax ? (unsigned)bi : (unsigned)L);
  const unsigned ksh = __reduce_max_sync(kFull, bi == b ? k2 : kb);
  nrm = __fsqrt_rn(warp_sum(nrm));
  if (lane == 0) {
    const float th = sim_of_key(kmax), tsh = sim_of_key(ksh);
    *sep = __fdiv_rn(__fmul_rn(__fmul_rn(nrm, __fsub_rn(th, tsh)), th),
                     fmaxf(tsh, 1e-12f));
    *best = b;
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

}  // namespace
