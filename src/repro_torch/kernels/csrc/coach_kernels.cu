// Hopper (sm_90a) kernels for the COACH boundary hop: the dequantize
// kernel and the C entry points of it and of the fused boundary kernel
// (its row pass in row_pass.cuh, built in row_pass_*.cu).  The quantize
// and the semantic probe have kernels of their own, in uaq_quantize.cu and
// semantic_probe.cu, with their design notes.
//
// Together they replace the four Pallas TPU kernels of the JAX package:
//   coach_fused_boundary  <- repro/kernels/boundary.py  fused_boundary
//                            (_boundary_kernel): quantize + int4/int8 pack
//                            + GAP + semantic probe in one read of x
//   coach_uaq_dequantize  <- repro/kernels/uaq.py  uaq_dequantize
//                            (_dequant_kernel)
//   coach_uaq_quantize    <- repro/kernels/uaq.py  uaq_quantize
//                            (_quant_kernel)
//   coach_semantic_probe  <- repro/kernels/semantic_cache.py
//                            semantic_probe (_probe_kernel)
//
// What bounds them: all four are row passes that do a few operations per
// byte (min/max, one division, a round per element; a GAP add), far below
// the card's ~20 flop/byte fp32 balance point, so each is bound by the
// bytes it moves through device memory.  The design keeps that traffic at
// one read of every input and one write of every output, with enough
// loads in flight and no block-wide barrier per row:
//   * row pass (K1): a CTA of 4 warps owns a run of rows (tokens)
//     of one batch row, and one warp owns one row at a time (a group of 2
//     or 4 warps when the row is wider than 2304 elements, or when there
//     are too few rows to fill the card).  The warp loads the whole row
//     into registers with 16-byte loads (D % 8 == 0 and an aligned
//     pointer; scalar loads otherwise, e.g. D = 33), takes min/max with
//     shuffles (no block-wide barrier per row), and quantizes and packs
//     from the registers, so the row is read once.  GAP adds each row into
//     the warp's own row of shared memory, at the columns each lane owns
//     (per-lane registers for them spilled: 255 registers with K1's row
//     held as well); the CTA combines its warps' sums once at the end, in
//     a fixed order, into one fp32 partial row;
//   * probe epilogue (K1), in the same launch: each CTA writes its
//     partial row to a (B, n_chunks, D) workspace and counts itself in a
//     per-batch-row arrival counter; the CTA that arrives last sums the
//     partials in chunk order (deterministic, no float atomics), runs the
//     probe with the centers spread over its warps and a shuffle top-2,
//     and sets the counter back to 0 for the next launch.  It is bound by
//     L2 latency, so its loads go out in batches before any is used.
//     Rows per CTA depend on the shape only, so the summation order is
//     the same on every card;
//   * dequantize (K2): a warp per row (and per slice of a row, so few rows
//     still spread over the card), scale and zp read once per row; a lane
//     reads 2 to 8 payload bytes and writes 16 bytes of values (4 float32
//     or 8 16-bit), so a warp's stores are 512 consecutive bytes.
// Activations are read as float32, bfloat16 or float16 and widened to
// float32 in registers; the dequantized values are written in any of the
// three (round to nearest even, like Tensor.to).
//
// Numerics: the wire fields must match the plain PyTorch version bit for
// bit, so every rounding step is spelled out with an IEEE round-to-nearest
// intrinsic (no contraction into FMA, no approximate division) and values
// are rounded half to even with rintf.  Build without --use_fast_math.
//   scale = fmaxf(hi - lo, 1e-8) * (1 / qmax)   (float32 reciprocal)
//   zp    = rint(-lo / scale)
//   q     = clamp(rint(x / scale + zp), 0, qmax)
// x / scale is the correctly rounded quotient, taken per element from the
// row's correctly rounded reciprocal (see quant1 in common.cuh).
// int4 packs channel 2j into the low nibble of byte j and 2j+1 into the
// high nibble; an odd D leaves the last high nibble zero.

#include "common.cuh"

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kDequantRows = 8;  // a warp a row, 8 rows a CTA

// ------------------------------------------------ dequantize
// A warp takes STEPS * 32 units of one row (blockIdx.x: which units,
// blockIdx.y: which 8 rows), each lane STEPS units of U = 16 / sizeof(T)
// values: it reads the unit's U * BITS / 8 payload bytes (2, 4 or 8) and
// writes the values with one 16-byte store, so a warp's stores cover 512
// consecutive bytes.  scale and zp are read once a row.  Without `vec`
// (odd N, or a payload or output that is not aligned) a unit is one
// channel, written alone.
template <typename T, int BITS, int STEPS>
__global__ void __launch_bounds__(32 * kDequantRows)
dequant_kernel(const uint8_t* __restrict__ p, const float* __restrict__ scale,
               const float* __restrict__ zp, T* __restrict__ out, int M, int P,
               int N, bool vec) {
  constexpr int U = 16 / sizeof(T);
  constexpr int UB = U * BITS / 8;  // payload bytes of a unit
  using Word = typename std::conditional<
      UB == 2, uint16_t,
      typename std::conditional<UB == 4, uint32_t, uint2>::type>::type;
  const int lane = threadIdx.x & 31;
  const int nu = vec ? N / U : N;
  const int j0 = blockIdx.x * 32 * STEPS + lane;
  for (int m = blockIdx.y * kDequantRows + (threadIdx.x >> 5); m < M;
       m += gridDim.y * kDequantRows) {
    const float sc = scale[m];
    const float z = zp[m];
    const uint8_t* pr = p + (size_t)m * P;
    T* orow = out + (size_t)m * N;
    if (vec) {
      Word w[STEPS];
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const int j = j0 + 32 * k;
        if (j < nu) w[k] = __ldg(reinterpret_cast<const Word*>(pr) + j);
      }
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const int j = j0 + 32 * k;
        if (j < nu) {
          uint64_t bits;
          if constexpr (UB == 8)
            bits = w[k].x | ((uint64_t)w[k].y << 32);
          else
            bits = w[k];
          float vals[U];
#pragma unroll
          for (int i = 0; i < U; ++i) {
            const uint32_t q = (uint32_t)(bits >> (i * BITS)) & ((1u << BITS) - 1u);
            vals[i] = __fmul_rn(__fsub_rn((float)q, z), sc);
          }
          store_vals<T, U>(orow + (size_t)j * U, vals);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const int c = j0 + 32 * k;
        if (c < N) {
          const uint32_t byte = pr[BITS == 4 ? c >> 1 : c];
          const uint32_t q = BITS == 4 ? (byte >> ((c & 1) * 4)) & 0xFu : byte;
          orow[c] = Elem<T>::narrow(__fmul_rn(__fsub_rn((float)q, z), sc));
        }
      }
    }
  }
}

template <typename T, int BITS>
cudaError_t launch_dequant(const void* payload, const void* scale,
                           const void* zp, void* out, int M, int P, int N,
                           cudaStream_t st) {
  constexpr int U = 16 / sizeof(T);
  constexpr int UB = U * BITS / 8;
  const bool vec = N % U == 0 && P % UB == 0 && aligned(payload, UB) &&
                   aligned(out, 16);
  const int nu = vec ? N / U : N;
  // many rows: two units a lane (more bytes in flight); few: one, so the
  // grid still spreads over the card
  const int steps = M >= 1024 ? 2 : 1;
  const dim3 grid((nu + 32 * steps - 1) / (32 * steps),
                  std::min((M + kDequantRows - 1) / kDequantRows, 65535));
  if (steps == 2)
    dequant_kernel<T, BITS, 2><<<grid, 32 * kDequantRows, 0, st>>>(
        static_cast<const uint8_t*>(payload), static_cast<const float*>(scale),
        static_cast<const float*>(zp), static_cast<T*>(out), M, P, N, vec);
  else
    dequant_kernel<T, BITS, 1><<<grid, 32 * kDequantRows, 0, st>>>(
        static_cast<const uint8_t*>(payload), static_cast<const float*>(scale),
        static_cast<const float*>(zp), static_cast<T*>(out), M, P, N, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequant_t(const void* payload, const void* scale,
                             const void* zp, void* out, int M, int P, int N,
                             int bits, cudaStream_t st) {
  if (bits == 4)
    return launch_dequant<T, 4>(payload, scale, zp, out, M, P, N, st);
  if (bits == 8)
    return launch_dequant<T, 8>(payload, scale, zp, out, M, P, N, st);
  return cudaErrorInvalidValue;
}

cudaError_t launch_rows(const RowArgs& a, int bits, int dtype,
                        cudaStream_t st) {
  if (a.B <= 0 || a.S <= 0 || a.D <= 0 || a.rows_per_cta <= 0 ||
      a.B > 65535 || a.L <= 0)
    return cudaErrorInvalidValue;
  // 16-byte loads of x (and up to 8-byte stores of the payload) need
  // D % 8 == 0 and aligned pointers
  const bool vec = a.D % 8 == 0 && aligned(a.x, 16) && aligned(a.payload, 8);
  switch (dtype) {
    case kF32:
      return (vec ? coach_rows_f32 : coach_rows_f32_scalar)(a, bits, st);
    case kBF16:
      return (vec ? coach_rows_bf16 : coach_rows_bf16_scalar)(a, bits, st);
    case kF16:
      return (vec ? coach_rows_f16 : coach_rows_f16_scalar)(a, bits, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// All entry points launch one kernel on `stream`, allocate nothing, do
// not synchronize, and return the launch's cudaError_t (0 on success).
// Tensors are contiguous; x is float32, bfloat16 or float16 (`dtype`,
// enum DType), centers float32; `counters` holds at least B zeroed
// unsigned ints that no other launch uses meanwhile, and is left zeroed.
// The fused boundary row pass runs `rows_per_cta` rows a CTA and `wpr`
// warps (1, 2 or 4) a row.

extern "C" int coach_fused_boundary(const void* x, const void* centers,
                                    void* payload, void* scale, void* zp,
                                    void* ws, void* counters, void* feat,
                                    void* sep, void* best, void* sims, int B,
                                    int S, int D, int L, int bits,
                                    int rows_per_cta, int wpr, int dtype,
                                    void* stream) {
  const RowArgs a{x,    payload, scale, zp, ws, counters,     centers, feat,
                  sep,  best,    sims,  B,  S,  D,            L,
                  rows_per_cta, wpr};
  return (int)launch_rows(a, bits, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int coach_uaq_dequantize(const void* payload, const void* scale,
                                    const void* zp, void* out, int M, int P,
                                    int N, int bits, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return (int)launch_dequant_t<float>(payload, scale, zp, out, M, P, N,
                                          bits, st);
    case kBF16:
      return (int)launch_dequant_t<__nv_bfloat16>(payload, scale, zp, out, M,
                                                  P, N, bits, st);
    case kF16:
      return (int)launch_dequant_t<__half>(payload, scale, zp, out, M, P, N,
                                           bits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The id of the CUDA-graph capture under way on `stream` into *id, or 0
// when none is (the fused boundary wrapper keeps arrival counters per
// capture).
extern "C" int coach_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status;
  unsigned long long cid = 0;
  const cudaError_t e = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &cid);
  *id = e == cudaSuccess && status == cudaStreamCaptureStatusActive ? cid : 0;
  return (int)e;
}
