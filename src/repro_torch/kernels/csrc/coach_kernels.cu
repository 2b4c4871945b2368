// Hopper (sm_90a) kernels for the COACH boundary hop.
//
// Replaces the four Pallas TPU kernels of the JAX package:
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
// one read of every input and one write of every output:
//   * one CTA of 256 threads owns a run of rows (tokens) of one batch row;
//     a row is read with 16-byte loads where D % 8 == 0 and the pointer is
//     aligned (scalar loads otherwise, e.g. D = 33), min/max are reduced
//     with warp shuffles, and the packing pass re-reads the row, which the
//     first pass has just brought into L1/L2;
//   * GAP (K1, K4) is deterministic without float atomics: each CTA sums
//     its rows in a fixed order into shared memory and writes one fp32
//     partial row to a (B, n_chunks, D) workspace; a second small kernel,
//     one 1024-thread CTA per batch row, sums the partials in chunk order
//     and runs the probe epilogue with independent loads throughout.  Rows per CTA depend on the shape only (about 528
//     CTAs in flight), so B = 1 still spreads over the card's SMs;
//   * the dequantize pass is one thread per output element over a
//     grid-stride loop, so any M works (no block-multiple assert).
//
// Numerics: the wire fields must match the plain PyTorch version bit for
// bit, so every rounding step is spelled out with an IEEE round-to-nearest
// intrinsic (no contraction into FMA, no approximate division) and values
// are rounded half to even with rintf.  Build without --use_fast_math.
//   scale = fmaxf(hi - lo, 1e-8) * (1 / qmax)   (float32 reciprocal)
//   zp    = rint(-lo / scale)
//   q     = clamp(rint(x / scale + zp), 0, qmax)
// int4 packs channel 2j into the low nibble of byte j and 2j+1 into the
// high nibble; an odd D leaves the last high nibble zero.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide min and max; every thread gets both.  `red` holds 2*kWarps.
__device__ __forceinline__ void block_minmax(float& lo, float& hi,
                                             float* red) {
  lo = warp_min(lo);
  hi = warp_max(hi);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[w] = lo;
    red[kWarps + w] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[kWarps];
  for (int i = 1; i < kWarps; ++i) {
    lo = fminf(lo, red[i]);
    hi = fmaxf(hi, red[kWarps + i]);
  }
  __syncthreads();  // red is rewritten by the next call
}

// Block-wide sum in a fixed order over NW warps; every thread gets it.
// `red` holds NW.
template <int NW>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float s = red[0];
  for (int i = 1; i < NW; ++i) s = __fadd_rn(s, red[i]);
  __syncthreads();
  return s;
}

template <int BITS>
__device__ __forceinline__ uint32_t quant1(float v, float sc, float z) {
  constexpr float qmax = float((1 << BITS) - 1);
  return (uint32_t)fminf(fmaxf(rintf(__fadd_rn(__fdiv_rn(v, sc), z)), 0.f),
                         qmax);
}

// Shared row quantize: per-token scale/zp from the block-wide min/max of
// the row, then the packed payload (16-byte loads of the row when `vec`).
template <int BITS>
__device__ __forceinline__ void row_quantize(const float* __restrict__ xr,
                                             int D, bool vec, float lo,
                                             float hi, float* red,
                                             uint8_t* __restrict__ pr,
                                             float* __restrict__ scale_out,
                                             float* __restrict__ zp_out) {
  block_minmax(lo, hi, red);
  const float inv_qmax = __fdiv_rn(1.0f, float((1 << BITS) - 1));
  const float sc = __fmul_rn(fmaxf(__fsub_rn(hi, lo), 1e-8f), inv_qmax);
  const float z = rintf(__fdiv_rn(-lo, sc));
  if (threadIdx.x == 0) {
    *scale_out = sc;
    *zp_out = z;
  }
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    if (BITS == 8) {
      uint32_t* p4 = reinterpret_cast<uint32_t*>(pr);
      for (int i = threadIdx.x; i < D / 4; i += kThreads) {
        const float4 v = x4[i];
        p4[i] = quant1<8>(v.x, sc, z) | (quant1<8>(v.y, sc, z) << 8) |
                (quant1<8>(v.z, sc, z) << 16) | (quant1<8>(v.w, sc, z) << 24);
      }
    } else {
      // 8 channels -> 4 bytes: byte j = q[2j] | q[2j+1] << 4
      uint32_t* p4 = reinterpret_cast<uint32_t*>(pr);
      for (int i = threadIdx.x; i < D / 8; i += kThreads) {
        const float4 a = x4[2 * i];
        const float4 b = x4[2 * i + 1];
        p4[i] = quant1<4>(a.x, sc, z) | (quant1<4>(a.y, sc, z) << 4) |
                (quant1<4>(a.z, sc, z) << 8) | (quant1<4>(a.w, sc, z) << 12) |
                (quant1<4>(b.x, sc, z) << 16) | (quant1<4>(b.y, sc, z) << 20) |
                (quant1<4>(b.z, sc, z) << 24) | (quant1<4>(b.w, sc, z) << 28);
      }
    }
  } else if (BITS == 8) {
    for (int c = threadIdx.x; c < D; c += kThreads)
      pr[c] = (uint8_t)quant1<8>(xr[c], sc, z);
  } else {
    const int P = (D + 1) / 2;
    for (int j = threadIdx.x; j < P; j += kThreads) {
      const uint32_t q0 = quant1<4>(xr[2 * j], sc, z);
      const uint32_t q1 = (2 * j + 1 < D) ? quant1<4>(xr[2 * j + 1], sc, z) : 0u;
      pr[j] = (uint8_t)(q0 | (q1 << 4));
    }
  }
}

// One CTA owns rows [s0, s1) of batch row blockIdx.y.  QUANT writes the
// wire fields of each row; GAP writes the CTA's column sums to
// ws[b, blockIdx.x, :].
template <int BITS, bool QUANT, bool GAP>
__global__ void __launch_bounds__(kThreads)
row_pass_kernel(const float* __restrict__ x, uint8_t* __restrict__ payload,
                float* __restrict__ scale, float* __restrict__ zp,
                float* __restrict__ ws, int S, int D, int P,
                int rows_per_cta, bool vec) {
  extern __shared__ float acc[];  // D floats when GAP
  __shared__ float red[2 * kWarps];
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int s0 = chunk * rows_per_cta;
  const int s1 = min(S, s0 + rows_per_cta);
  if (GAP) {
    for (int c = threadIdx.x; c < D; c += kThreads) acc[c] = 0.f;
    __syncthreads();
  }
  for (int s = s0; s < s1; ++s) {
    const size_t row = (size_t)b * S + s;
    const float* xr = x + row * D;
    float lo = INFINITY, hi = -INFINITY;
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      for (int i = threadIdx.x; i < D / 4; i += kThreads) {
        const float4 v = x4[i];
        lo = fminf(lo, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
        hi = fmaxf(hi, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
        if (GAP) {
          acc[4 * i] = __fadd_rn(acc[4 * i], v.x);
          acc[4 * i + 1] = __fadd_rn(acc[4 * i + 1], v.y);
          acc[4 * i + 2] = __fadd_rn(acc[4 * i + 2], v.z);
          acc[4 * i + 3] = __fadd_rn(acc[4 * i + 3], v.w);
        }
      }
    } else {
      for (int c = threadIdx.x; c < D; c += kThreads) {
        const float v = xr[c];
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
        if (GAP) acc[c] = __fadd_rn(acc[c], v);
      }
    }
    if (QUANT)
      row_quantize<BITS>(xr, D, vec, lo, hi, red, payload + row * P,
                         scale + row, zp + row);
  }
  if (GAP) {
    __syncthreads();
    float* w = ws + ((size_t)b * gridDim.x + chunk) * D;
    for (int c = threadIdx.x; c < D; c += kThreads) w[c] = acc[c];
  }
}

// Shared probe epilogue, one CTA of 1024 threads per batch row: sum the
// n_chunks partial rows in order, divide by the true S, L2-normalize, then
// cosine against every center (fp32 on CUDA cores: L is small), map to
// [0, 1] (Eq. 8), then top-1 (first index on ties), top-2 and sep (Eq. 9).
// Every step is a row of independent loads (the partial sums unrolled,
// the centers taken kTileL at a time with each center's norm and dot in
// one pass), so the one CTA is not held up by load latency.
constexpr int kEpiThreads = 1024;
constexpr int kEpiWarps = kEpiThreads / 32;
constexpr int kTileL = 8;

__global__ void __launch_bounds__(kEpiThreads)
probe_epilogue_kernel(const float* __restrict__ ws,
                      const float* __restrict__ centers,
                      float* __restrict__ feat, float* __restrict__ sep,
                      int* __restrict__ best, float* __restrict__ sims,
                      int n_chunks, int S, int D, int L) {
  extern __shared__ float sm[];  // fn[D], sims[L]
  float* fn = sm;
  float* sl = sm + D;
  __shared__ float red[kEpiWarps][2 * kTileL];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* w = ws + (size_t)b * n_chunks * D;
  float ss = 0.f;
  for (int c = threadIdx.x; c < D; c += kEpiThreads) {
    float t = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_chunks; ++j) t = __fadd_rn(t, w[(size_t)j * D + c]);
    const float f = __fdiv_rn(t, (float)S);
    if (feat != nullptr) feat[(size_t)b * D + c] = f;
    fn[c] = f;
    ss = __fmaf_rn(f, f, ss);
  }
  ss = block_sum<kEpiWarps>(ss, &red[0][0]);
  const float fnorm = fmaxf(__fsqrt_rn(ss), 1e-12f);
  // each thread rescales and later reads back only its own columns
  for (int c = threadIdx.x; c < D; c += kEpiThreads)
    fn[c] = __fdiv_rn(fn[c], fnorm);
  for (int l0 = 0; l0 < L; l0 += kTileL) {
    const int nl = min(kTileL, L - l0);
    float cs[kTileL], dt[kTileL];
#pragma unroll
    for (int k = 0; k < kTileL; ++k) cs[k] = dt[k] = 0.f;
    for (int c = threadIdx.x; c < D; c += kEpiThreads) {
      const float fc = fn[c];
#pragma unroll
      for (int k = 0; k < kTileL; ++k)
        if (k < nl) {
          const float v = centers[(size_t)(l0 + k) * D + c];
          cs[k] = __fmaf_rn(v, v, cs[k]);
          dt[k] = __fmaf_rn(fc, v, dt[k]);
        }
    }
#pragma unroll
    for (int k = 0; k < kTileL; ++k) {
      cs[k] = warp_sum(cs[k]);
      dt[k] = warp_sum(dt[k]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kTileL; ++k) {
        red[warp][k] = cs[k];
        red[warp][kTileL + k] = dt[k];
      }
    }
    __syncthreads();
    if (threadIdx.x < nl) {
      float a = 0.f, d = 0.f;
      for (int i = 0; i < kEpiWarps; ++i) {
        a = __fadd_rn(a, red[i][threadIdx.x]);
        d = __fadd_rn(d, red[i][kTileL + threadIdx.x]);
      }
      // cos = (fn . c) / max(|c|, 1e-12)
      const float cnorm = fmaxf(__fsqrt_rn(a), 1e-12f);
      sl[l0 + threadIdx.x] =
          __fmul_rn(__fadd_rn(__fdiv_rn(d, cnorm), 1.f), 0.5f);
    }
    __syncthreads();
  }
  for (int l = threadIdx.x; l < L; l += kEpiThreads)
    sims[(size_t)b * L + l] = sl[l];
  if (threadIdx.x == 0) {
    float th = sl[0];
    int bi = 0;
    for (int l = 1; l < L; ++l)
      if (sl[l] > th) {
        th = sl[l];
        bi = l;
      }
    float tsh = -INFINITY, nrm = 0.f;
    for (int l = 0; l < L; ++l) {
      if (l != bi) tsh = fmaxf(tsh, sl[l]);
      nrm = __fmaf_rn(sl[l], sl[l], nrm);
    }
    nrm = __fsqrt_rn(nrm);
    sep[b] = __fdiv_rn(__fmul_rn(__fmul_rn(nrm, __fsub_rn(th, tsh)), th),
                       fmaxf(tsh, 1e-12f));
    best[b] = bi;
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const uint8_t* __restrict__ p, const float* __restrict__ scale,
               const float* __restrict__ zp, float* __restrict__ out, int M,
               int P, int N) {
  const size_t total = (size_t)M * N;
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += stride) {
    const size_t m = i / N;
    const int n = (int)(i - m * N);
    uint32_t q;
    if (BITS == 4) {
      const uint32_t byte = p[m * P + (n >> 1)];
      q = (n & 1) ? (byte >> 4) : (byte & 0xFu);
    } else {
      q = p[m * P + n];
    }
    out[i] = __fmul_rn(__fsub_rn((float)q, zp[m]), scale[m]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

template <int BITS, bool QUANT, bool GAP>
cudaError_t launch_rows(const void* x, void* payload, void* scale, void* zp,
                        void* ws, int B, int S, int D, int rows_per_cta,
                        cudaStream_t st) {
  if (B <= 0 || S <= 0 || D <= 0 || rows_per_cta <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  const int P = QUANT ? (BITS == 4 ? (D + 1) / 2 : D) : 0;
  const bool vec = (D % 8 == 0) && aligned(x, 16) &&
                   (!QUANT || aligned(payload, 4));
  const int n_chunks = (S + rows_per_cta - 1) / rows_per_cta;
  const size_t smem = GAP ? (size_t)D * sizeof(float) : 0;
  cudaError_t e = allow_smem(row_pass_kernel<BITS, QUANT, GAP>, smem);
  if (e != cudaSuccess) return e;
  row_pass_kernel<BITS, QUANT, GAP><<<dim3(n_chunks, B), kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(payload),
      static_cast<float*>(scale), static_cast<float*>(zp),
      static_cast<float*>(ws), S, D, P, rows_per_cta, vec);
  return cudaGetLastError();
}

cudaError_t launch_epilogue(const void* ws, const void* centers, void* feat,
                            void* sep, void* best, void* sims, int B,
                            int n_chunks, int S, int D, int L,
                            cudaStream_t st) {
  if (L <= 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(D + L) * sizeof(float);
  cudaError_t e = allow_smem(probe_epilogue_kernel, smem);
  if (e != cudaSuccess) return e;
  probe_epilogue_kernel<<<B, kEpiThreads, smem, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(centers),
      static_cast<float*>(feat), static_cast<float*>(sep),
      static_cast<int*>(best), static_cast<float*>(sims), n_chunks, S, D, L);
  return cudaGetLastError();
}

}  // namespace

// All entry points launch on `stream`, allocate nothing, do not
// synchronize, and return the launch's cudaError_t (0 on success).
// Tensors are contiguous; x and centers are float32.

extern "C" int coach_fused_boundary(const void* x, const void* centers,
                                    void* payload, void* scale, void* zp,
                                    void* ws, void* feat, void* sep,
                                    void* best, void* sims, int B, int S,
                                    int D, int L, int bits, int rows_per_cta,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bits == 4)
    e = launch_rows<4, true, true>(x, payload, scale, zp, ws, B, S, D,
                                   rows_per_cta, st);
  else if (bits == 8)
    e = launch_rows<8, true, true>(x, payload, scale, zp, ws, B, S, D,
                                   rows_per_cta, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (S + rows_per_cta - 1) / rows_per_cta;
  return (int)launch_epilogue(ws, centers, feat, sep, best, sims, B,
                              n_chunks, S, D, L, st);
}

extern "C" int coach_uaq_quantize(const void* x, void* payload, void* scale,
                                  void* zp, int M, int N, int bits,
                                  int rows_per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return (int)launch_rows<4, true, false>(x, payload, scale, zp, nullptr, 1,
                                            M, N, rows_per_cta, st);
  if (bits == 8)
    return (int)launch_rows<8, true, false>(x, payload, scale, zp, nullptr, 1,
                                            M, N, rows_per_cta, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int coach_semantic_probe(const void* x, const void* centers,
                                    void* ws, void* sep, void* best,
                                    void* sims, int B, int S, int D, int L,
                                    int rows_per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_rows<8, false, true>(x, nullptr, nullptr, nullptr, ws,
                                              B, S, D, rows_per_cta, st);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (S + rows_per_cta - 1) / rows_per_cta;
  return (int)launch_epilogue(ws, centers, nullptr, sep, best, sims, B,
                              n_chunks, S, D, L, st);
}

extern "C" int coach_uaq_dequantize(const void* payload, const void* scale,
                                    const void* zp, void* out, int M, int P,
                                    int N, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)M * N;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8192 ? want : 8192);
  if (bits == 4)
    dequant_kernel<4><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(payload), static_cast<const float*>(scale),
        static_cast<const float*>(zp), static_cast<float*>(out), M, P, N);
  else if (bits == 8)
    dequant_kernel<8><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(payload), static_cast<const float*>(scale),
        static_cast<const float*>(zp), static_cast<float*>(out), M, P, N);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
