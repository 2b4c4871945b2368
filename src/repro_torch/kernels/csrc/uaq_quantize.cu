// K3 uaq_quantize: row-wise UAQ quantize (+ int4 pack) for Hopper
// (sm_90a).  Replaces the Pallas uaq_quantize (_quant_kernel) of
// repro/kernels/uaq.py.
//
// What bounds it: a few operations per byte (min/max, one division, a
// round per element), so at many rows the bytes through device memory
// (one read of x, one write of the wire fields); at the main path's few
// rows (8 rows of 768-4096 elements: the relays of the three-tier
// runtime) the chain of dependent steps after the launch: load the row,
// reduce it, divide, pack, store.
//   * A CTA of 1-8 warps takes one row and holds it in registers, at most
//     kLaneCap elements a thread.  A thread owns units of U = 64 / BITS
//     consecutive elements (8 at 8 bits, 16 at 4 bits): one to four
//     16-byte loads, and one 8-byte payload store.  Every load of the row
//     is issued before any is used.  The row's min and max take one
//     redux.sync each a warp (no shuffle tree), and the warps of a row
//     meet once in shared memory behind one barrier.  Few rows get
//     more warps a row (kernels/_build.py, quantize_warps), since then the
//     chain of one row's steps is the time; many rows one warp, a CTA a
//     row, so that ~13 rows an SM are in flight at 150 registers a thread
//     (88.7% of the bytes bound at 32768 rows of 2304 on an H100).  A
//     persistent kernel whose warps kept rings of rows in shared memory,
//     filled by TMA bulk copies, measured 131-134 us there against this
//     path's 127 us (PERF.md §6), and was dropped;
//   * odd widths and unaligned pointers (correctness-only shapes): a warp
//     a row, one element a load, read twice (the second from L1/L2).
//
// Numerics are those of the fused boundary kernel's row quantize (K1,
// row_pass.cuh), so the wire fields are bit-equal to K1's and to the plain
// version (coach_kernels.cu has the formulas; quant1 and row_qparams in
// common.cuh).  The min and max are exact, and K1's: per lane with
// min.NaN / max.NaN, across the warp with redux.sync on an
// order-preserving unsigned key of the float (warp_minmax).  Two
// differences from fminf / fmaxf, both on purpose:
//   * the key orders -0.0 below +0.0, where torch.amin may return either;
//     a row whose min is a zero may get zp = -0.0 where the plain version
//     gets +0.0 (or the other way), which compare equal (torch.equal) and
//     quantize alike;
//   * a NaN anywhere in a row makes its lo, hi, scale and zp NaN and every
//     code 0, as torch.amin / torch.clamp / .to(uint8) do in the plain
//     version (jnp.min propagates NaN too); fminf would drop it.

#include "common.cuh"

namespace {

constexpr int kLaneCap = 128;  // row elements a thread holds
constexpr int kMaxWarps = 8;   // warps a CTA

// ------------------------------------------------ row min/max -> params
// The row parameters from each lane's lo / hi: across the warp
// (warp_minmax), then, given `mm` (one entry a warp), across the CTA's
// warps, which hold one row.
template <int BITS>
__device__ __forceinline__ RowQ row_params(float lo, float hi,
                                           MinMaxKeys* mm = nullptr) {
  MinMaxKeys k = warp_minmax(lo, hi);
  const int warps = blockDim.x >> 5;
  if (mm != nullptr && warps > 1) {
    if ((threadIdx.x & 31) == 0) mm[threadIdx.x >> 5] = k;
    __syncthreads();
    for (int i = 0; i < warps; ++i) merge_minmax(k, mm[i]);
  }
  return row_qparams<BITS>(k);
}

// ------------------------------------------------ units
// A unit: U = 64 / BITS consecutive elements, NL = U / kVec 16-byte
// loads of x, one 8-byte payload word (element i at bits i * BITS: the
// low nibble is the even channel).
template <typename T, int BITS>
struct UnitOf {
  static constexpr int U = 64 / BITS;
  static constexpr int NL = U / Elem<T>::kVec;
};

template <typename T, int BITS>
__device__ __forceinline__ void widen_unit(const uint4 (&raw)[UnitOf<T, BITS>::NL],
                                           float* v) {
#pragma unroll
  for (int j = 0; j < UnitOf<T, BITS>::NL; ++j)
    Elem<T>::widen16(raw[j], v + j * Elem<T>::kVec);
}

template <int BITS, bool FAST>
__device__ __forceinline__ uint2 pack_unit(const float* v, const RowQ& p) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 64 / BITS; ++i)
    w[(i * BITS) / 32] |= quant1<BITS, FAST>(v[i], p.sc, p.r, p.z)
                          << ((i * BITS) % 32);
  return make_uint2(w[0], w[1]);
}

// ------------------------------------------------ register path
// CTA blockIdx.x takes row blockIdx.x with its blockDim.x / 32 warps;
// thread g of the CTA holds units g, g + blockDim.x, ...
template <typename T, int BITS>
__global__ void __launch_bounds__(32 * kMaxWarps)
uaq_quantize_rows_kernel(const T* __restrict__ x, uint8_t* __restrict__ payload,
                         float* __restrict__ scale, float* __restrict__ zp,
                         int D) {
  using Un = UnitOf<T, BITS>;
  constexpr int U = Un::U, NL = Un::NL, KU = kLaneCap / U;
  __shared__ MinMaxKeys mm[kMaxWarps];
  const int g = threadIdx.x;
  const int gstride = blockDim.x;
  const int row = blockIdx.x;
  const int nu = D / U;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  uint4 raw[KU][NL];
#pragma unroll
  for (int k = 0; k < KU; ++k) {
    if (gstride * k >= nu) break;
    const int u = g + gstride * k;
    if (u < nu)
#pragma unroll
      for (int j = 0; j < NL; ++j) raw[k][j] = __ldg(xr + u * NL + j);
  }
  float v[KU][U];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < KU; ++k) {
    if (gstride * k >= nu) break;
    if (g + gstride * k < nu) {
      widen_unit<T, BITS>(raw[k], v[k]);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        lo = fmin_nan(lo, v[k][i]);
        hi = fmax_nan(hi, v[k][i]);
      }
    }
  }
  const RowQ p = row_params<BITS>(lo, hi, mm);
  if (g == 0) {
    scale[row] = p.sc;
    zp[row] = p.z;
  }
  uint2* pr = reinterpret_cast<uint2*>(payload + (size_t)row * (nu * 8));
  if (p.fast) {
#pragma unroll
    for (int k = 0; k < KU; ++k) {
      if (gstride * k >= nu) break;
      if (g + gstride * k < nu)
        pr[g + gstride * k] = pack_unit<BITS, true>(v[k], p);
    }
  } else {
#pragma unroll
    for (int k = 0; k < KU; ++k) {
      if (gstride * k >= nu) break;
      if (g + gstride * k < nu)
        pr[g + gstride * k] = pack_unit<BITS, false>(v[k], p);
    }
  }
}

// ------------------------------------------------ scalar path
template <int BITS>
__device__ __forceinline__ uint32_t quant_row(float v, const RowQ& p) {
  return p.fast ? quant1<BITS, true>(v, p.sc, p.r, p.z)
                : quant1<BITS, false>(v, p.sc, p.r, p.z);
}

template <typename T, int BITS>
__global__ void __launch_bounds__(32 * kMaxWarps)
uaq_quantize_scalar_kernel(const T* __restrict__ x,
                           uint8_t* __restrict__ payload,
                           float* __restrict__ scale, float* __restrict__ zp,
                           int M, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float lo = INFINITY, hi = -INFINITY;
  for (int c = lane; c < D; c += 32) {
    const float v = Elem<T>::widen(xr[c]);
    lo = fmin_nan(lo, v);
    hi = fmax_nan(hi, v);
  }
  const RowQ p = row_params<BITS>(lo, hi);
  if (lane == 0) {
    scale[row] = p.sc;
    zp[row] = p.z;
  }
  if constexpr (BITS == 8) {
    uint8_t* pr = payload + (size_t)row * D;
    for (int c = lane; c < D; c += 32)
      pr[c] = (uint8_t)quant_row<BITS>(Elem<T>::widen(xr[c]), p);
  } else {
    const int P = (D + 1) / 2;  // an odd D: the last high nibble is 0
    uint8_t* pr = payload + (size_t)row * P;
    for (int j = lane; j < P; j += 32) {
      const uint32_t q0 = quant_row<BITS>(Elem<T>::widen(xr[2 * j]), p);
      const uint32_t q1 =
          2 * j + 1 < D ? quant_row<BITS>(Elem<T>::widen(xr[2 * j + 1]), p)
                        : 0u;
      pr[j] = (uint8_t)(q0 | (q1 << 4));
    }
  }
}

// ------------------------------------------------ host side
template <typename T, int BITS>
cudaError_t launch_quantize(const void* x, void* payload, void* scale,
                            void* zp, int M, int D, int warps,
                            cudaStream_t st) {
  if (warps < 1 || warps > kMaxWarps) return cudaErrorInvalidValue;
  constexpr int U = UnitOf<T, BITS>::U;
  const bool vec = D % U == 0 && aligned(x, 16) && aligned(payload, 8);
  const T* xt = static_cast<const T*>(x);
  uint8_t* pt = static_cast<uint8_t*>(payload);
  float* sc = static_cast<float*>(scale);
  float* zt = static_cast<float*>(zp);
  if (!vec) {
    const unsigned grid = (unsigned)((M + warps - 1) / warps);
    uaq_quantize_scalar_kernel<T, BITS><<<grid, 32 * warps, 0, st>>>(
        xt, pt, sc, zt, M, D);
  } else {
    if (D > 32 * warps * kLaneCap) return cudaErrorInvalidValue;
    uaq_quantize_rows_kernel<T, BITS><<<M, 32 * warps, 0, st>>>(xt, pt, sc,
                                                                zt, D);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quantize_t(const void* x, void* payload, void* scale,
                              void* zp, int M, int D, int bits, int warps,
                              cudaStream_t st) {
  if (bits == 4)
    return launch_quantize<T, 4>(x, payload, scale, zp, M, D, warps, st);
  if (bits == 8)
    return launch_quantize<T, 8>(x, payload, scale, zp, M, D, warps, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, N) of `dtype` (enum DType) -> payload (M, ceil(N * bits / 8))
// uint8, scale and zp (M,) float32, in one launch on `stream`: M CTAs of
// `warps` warps (1-8), a CTA a row (N <= 4096 * warps); odd or unaligned
// widths take CTAs of `warps` warps and a warp a row.
extern "C" int coach_uaq_quantize(const void* x, void* payload, void* scale,
                                  void* zp, int M, int N, int bits, int warps,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return (int)launch_quantize_t<float>(x, payload, scale, zp, M, N, bits,
                                           warps, st);
    case kBF16:
      return (int)launch_quantize_t<__nv_bfloat16>(x, payload, scale, zp, M,
                                                   N, bits, warps, st);
    case kF16:
      return (int)launch_quantize_t<__half>(x, payload, scale, zp, M, N, bits,
                                            warps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
