// Row-pass kernel of K1, the fused boundary (quantize + pack + GAP +
// probe).  Instantiated per activation type and load width in
// row_pass_*.cu; the design notes are in coach_kernels.cu.
#pragma once

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kRowWarps = 4;  // warps per row-pass CTA
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowCtasPerSm = 3;  // registers for 3 CTAs an SM (168 each)
constexpr int kLaneElems = 72;  // row elements a lane holds: D=2304 per warp
constexpr int kTileL = 4;       // centers a warp takes at a time

// ------------------------------------------------ probe epilogue
// Run by the last CTA of batch row b: sum the n_chunks partial rows in
// order, divide by the true S, then cosine against every center (fp32 on
// CUDA cores: L is small; f . c / (|f| |c|), so f is not rescaled), map to
// [0, 1] (Eq. 8), then top-1, top-2 and sep (Eq. 9) as the plain version
// takes them (probe_top2: torch.argmax's order, NaN carried).
// `sm` holds D + L floats.
//
// It is a few hundred KB read from L2 by one SM, so it is bound by load
// latency: every loop below issues a batch of loads (indices clamped to a
// valid element, so no load sits behind a branch) before it uses any of
// them, 20-24 loads a thread.  Columns are taken W at a time (16-byte
// loads when W == 4).
constexpr int kQB = 5;  // column groups a thread sums at a time
constexpr int kJB = 4;  // partial rows loaded at a time
constexpr int kQC = 6;  // column groups a lane takes per center at a time

// L2 loads (.cg): other CTAs wrote the partial rows
template <int W>
__device__ __forceinline__ void ld_cg(const float* p, float* o) {
  if constexpr (W == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
    o[0] = __ldcg(p);
  }
}

template <int W>
__device__ void probe_epilogue(const float* __restrict__ w, int n_chunks,
                               const float* __restrict__ centers,
                               float* __restrict__ feat, float* __restrict__ sep,
                               int* __restrict__ best, float* __restrict__ sims,
                               int S, int D, int L, float* sm) {
  __shared__ float red[kRowWarps];
  float* fs = sm;  // f
  float* sl = sm + D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nu = D / W;  // column groups
  const float sf = (float)S;
  float ss = 0.f;
  for (int u0 = threadIdx.x; u0 < nu; u0 += kRowThreads * kQB) {
    float t[kQB][W];
    int uc[kQB];
#pragma unroll
    for (int a = 0; a < kQB; ++a) {
      const int u = u0 + a * kRowThreads;
      uc[a] = u < nu ? u : u0;
#pragma unroll
      for (int i = 0; i < W; ++i) t[a][i] = 0.f;
    }
    for (int j = 0; j < n_chunks; j += kJB) {
      float p[kJB][kQB][W];
#pragma unroll
      for (int jj = 0; jj < kJB; ++jj)
#pragma unroll
        for (int a = 0; a < kQB; ++a)
          ld_cg<W>(w + (size_t)min(j + jj, n_chunks - 1) * D + uc[a] * W,
                   p[jj][a]);
#pragma unroll
      for (int jj = 0; jj < kJB; ++jj)
        if (j + jj < n_chunks) {
#pragma unroll
          for (int a = 0; a < kQB; ++a)
#pragma unroll
            for (int i = 0; i < W; ++i)
              t[a][i] = __fadd_rn(t[a][i], p[jj][a][i]);
        }
    }
#pragma unroll
    for (int a = 0; a < kQB; ++a) {
      const int u = u0 + a * kRowThreads;
      if (u < nu) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const float f = __fdiv_rn(t[a][i], sf);
          feat[u * W + i] = f;
          fs[u * W + i] = f;
          ss = __fmaf_rn(f, f, ss);
        }
      }
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  ss = red[0];
#pragma unroll
  for (int i = 1; i < kRowWarps; ++i) ss = __fadd_rn(ss, red[i]);
  const float fnorm = fmaxf(__fsqrt_rn(ss), 1e-12f);
  // centers: warp w takes kTileL of them at a time, each center's norm
  // and dot in one pass
  for (int l0 = warp * kTileL; l0 < L; l0 += kRowWarps * kTileL) {
    float cs[kTileL], dt[kTileL];
    int lc[kTileL];
#pragma unroll
    for (int k = 0; k < kTileL; ++k) {
      cs[k] = dt[k] = 0.f;
      lc[k] = min(l0 + k, L - 1);
    }
    for (int u0 = lane; u0 < nu; u0 += 32 * kQC) {
      float v[kTileL][kQC][W];
      int uc[kQC];
#pragma unroll
      for (int a = 0; a < kQC; ++a) {
        const int u = u0 + 32 * a;
        uc[a] = u < nu ? u : u0;
      }
#pragma unroll
      for (int k = 0; k < kTileL; ++k)
#pragma unroll
        for (int a = 0; a < kQC; ++a)
          ld_cg<W>(centers + (size_t)lc[k] * D + uc[a] * W, v[k][a]);
#pragma unroll
      for (int a = 0; a < kQC; ++a)
        if (u0 + 32 * a < nu) {
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const float f = fs[uc[a] * W + i];
#pragma unroll
            for (int k = 0; k < kTileL; ++k) {
              cs[k] = __fmaf_rn(v[k][a][i], v[k][a][i], cs[k]);
              dt[k] = __fmaf_rn(f, v[k][a][i], dt[k]);
            }
          }
        }
    }
#pragma unroll
    for (int k = 0; k < kTileL; ++k) {
      cs[k] = warp_sum(cs[k]);
      dt[k] = warp_sum(dt[k]);
      // cos = (f . c) / max(|f|, 1e-12) / max(|c|, 1e-12)
      if (lane == k && l0 + k < L) {
        const float cnorm = fmaxf(__fsqrt_rn(cs[k]), 1e-12f);
        const float s = __fmul_rn(
            __fadd_rn(__fdiv_rn(__fdiv_rn(dt[k], fnorm), cnorm), 1.f), 0.5f);
        sl[l0 + k] = s;
        sims[l0 + k] = s;
      }
    }
  }
  __syncthreads();
  if (warp == 0) probe_top2(sl, L, sep, best);
}

// ------------------------------------------------ row pass
// CTA (blockIdx.x, blockIdx.y) owns rows [s0, s1) of batch row b =
// blockIdx.y.  Its warps come in groups of `wpr` (1, 2 or 4), one row in
// flight per group; lane g of a group holds vectors g, g + 32*wpr, ... of
// the row (VEC elements each) in registers.  It writes the wire fields of
// each row and adds it into the group's row of shared memory (the
// lane's own columns, so no barrier); the CTA writes its partial, the
// groups summed in order, to ws[b, blockIdx.x] and, in the last CTA of
// batch row b, runs the probe epilogue.
template <int VEC>
__device__ __forceinline__ void gap_add(float* acc, const float* v) {
  if constexpr (VEC == 1) {
    acc[0] = __fadd_rn(acc[0], v[0]);
  } else {
#pragma unroll
    for (int h = 0; h < VEC; h += 4) {
      float4* a4 = reinterpret_cast<float4*>(acc + h);
      float4 a = *a4;
      a.x = __fadd_rn(a.x, v[h]);
      a.y = __fadd_rn(a.y, v[h + 1]);
      a.z = __fadd_rn(a.z, v[h + 2]);
      a.w = __fadd_rn(a.w, v[h + 3]);
      *a4 = a;
    }
  }
  // one slot at a time: hoisting every slot's shared loads above the
  // adds would need registers for them beside the row, and spill
  asm volatile("" ::: "memory");
}

// Quantize and pack the lane's slots of one row (see row_pass_kernel).
template <int VEC, int BITS, int NV, bool FAST>
__device__ __forceinline__ void pack_row(const float (&v)[NV * VEC],
                                         uint8_t* __restrict__ pr, float sc,
                                         float r, float z, int g, int gstride,
                                         int nvec, int D) {
#pragma unroll (VEC == 1 ? 1 : NV)
  for (int k = 0; k < NV; ++k) {
    if (k * gstride >= nvec) break;
    const int vi = g + k * gstride;
    if constexpr (VEC == 1) {
      // lanes 2j and 2j+1 hold channels 2j and 2j+1 (gstride is even)
      const uint32_t q = vi < D ? quant1<BITS, FAST>(v[k], sc, r, z) : 0u;
      if (BITS == 8) {
        if (vi < D) pr[vi] = (uint8_t)q;
      } else {
        const uint32_t qn = __shfl_down_sync(kFull, q, 1);
        if ((threadIdx.x & 1) == 0 && vi < D)
          pr[vi >> 1] = (uint8_t)(q | (qn << 4));
      }
    } else if (vi < nvec) {
      uint32_t w[VEC * BITS / 32 > 0 ? VEC * BITS / 32 : 1] = {};
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        w[(i * BITS) / 32] |= quant1<BITS, FAST>(v[k * VEC + i], sc, r, z)
                              << ((i * BITS) % 32);
      constexpr int kBytes = VEC * BITS / 8;  // 2, 4 or 8
      uint8_t* dst = pr + (size_t)vi * kBytes;
      if constexpr (kBytes == 2)
        *reinterpret_cast<uint16_t*>(dst) = (uint16_t)w[0];
      else if constexpr (kBytes == 4)
        *reinterpret_cast<uint32_t*>(dst) = w[0];
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The scalar path (odd widths, unaligned rows) keeps its 72 slots a lane
// in local memory: its slot loops are not unrolled, which keeps the build
// short; it is not the path of any model's width.
template <typename T, int VEC, int BITS>
__global__ void __launch_bounds__(kRowThreads, kRowCtasPerSm)
row_pass_kernel(const T* __restrict__ x, uint8_t* __restrict__ payload,
                float* __restrict__ scale, float* __restrict__ zp,
                float* __restrict__ ws, unsigned* __restrict__ counters,
                const float* __restrict__ centers, float* __restrict__ feat,
                float* __restrict__ sep, int* __restrict__ best,
                float* __restrict__ sims, int S, int D, int L,
                int rows_per_cta, int wpr) {
  constexpr int NV = kLaneElems / VEC;  // vector slots per lane
  // ng rows of D GAP sums, then f and sims in the epilogue
  extern __shared__ float sm[];
  __shared__ MinMaxKeys mm[2][kRowWarps];  // min/max per warp, 2 rows
  __shared__ int is_last;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ng = kRowWarps / wpr;  // row groups in the CTA
  const int grp = warp / wpr;
  const int g = (warp - grp * wpr) * 32 + lane;
  const int gstride = 32 * wpr;
  const int nvec = D / VEC;
  const int P = BITS == 4 ? (D + 1) / 2 : D;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * rows_per_cta;
  const int s1 = min(S, s0 + rows_per_cta);
  float* acc = sm + grp * D;  // this group's GAP sums
#pragma unroll (VEC == 1 ? 1 : NV)
  for (int k = 0; k < NV; ++k) {
    if (k * gstride >= nvec) break;
    const int vi = g + k * gstride;
    if (vi < nvec)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[vi * VEC + i] = 0.f;
  }
  int parity = 0;
  for (int s = s0 + grp; s < s1; s += ng, parity ^= 1) {
    const size_t row = (size_t)b * S + s;
    const T* xr = x + row * D;
    float v[NV * VEC];
    // every load of the row first, so all are in flight together
#pragma unroll (VEC == 1 ? 1 : NV)
    for (int k = 0; k < NV; ++k) {
      if (k * gstride >= nvec) break;
      const int vi = g + k * gstride;
      if (vi < nvec) {
        if constexpr (VEC == 1)
          v[k] = Elem<T>::widen(xr[vi]);
        else
          Elem<T>::widen16(reinterpret_cast<const uint4*>(xr)[vi], &v[k * VEC]);
      }
    }
    // the group's next row into L2 meanwhile (no registers held), so its
    // loads find it there while this row is quantized
    if (s + ng < s1) {
      const char* xn = reinterpret_cast<const char*>(xr + (size_t)ng * D);
      const int lines = (D * (int)sizeof(T) + 127) / 128;
      for (int l = g; l < lines; l += gstride) prefetch_l2(xn + 128 * l);
    }
    float lo = INFINITY, hi = -INFINITY;
#pragma unroll (VEC == 1 ? 1 : NV)
    for (int k = 0; k < NV; ++k) {
      if (k * gstride >= nvec) break;
      const int vi = g + k * gstride;
      if (vi < nvec) {
        gap_add<VEC>(acc + vi * VEC, &v[k * VEC]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          lo = fmin_nan(lo, v[k * VEC + i]);
          hi = fmax_nan(hi, v[k * VEC + i]);
        }
      }
    }
    // K3's min / max (NaN carried, -0.0 below +0.0) and row parameters
    MinMaxKeys mk = warp_minmax(lo, hi);
    if (wpr > 1) {  // combine the group's warps (exact: min/max)
      if (lane == 0) mm[parity][warp] = mk;
      group_sync(1 + grp, gstride);
      for (int i = 0; i < wpr; ++i)
        merge_minmax(mk, mm[parity][grp * wpr + i]);
    }
    const RowQ q = row_qparams<BITS>(mk);
    const float sc = q.sc, z = q.z, r = q.r;
    const bool fast = q.fast;
    if (g == 0) {
      scale[row] = sc;
      zp[row] = z;
    }
    uint8_t* pr = payload + row * P;
    if (fast)
      pack_row<VEC, BITS, NV, true>(v, pr, sc, r, z, g, gstride, nvec, D);
    else
      pack_row<VEC, BITS, NV, false>(v, pr, sc, r, z, g, gstride, nvec, D);
  }
  __syncthreads();
  const int n_chunks = gridDim.x;
  float* w = ws + (size_t)b * n_chunks * D;
  for (int c = threadIdx.x; c < D; c += kRowThreads) {
    float t = sm[c];
    for (int i = 1; i < ng; ++i) t = __fadd_rn(t, sm[i * D + c]);
    w[(size_t)blockIdx.x * D + c] = t;
  }
  // publish the partial, then count this CTA in
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(&counters[b], 1u) == (unsigned)(n_chunks - 1);
    if (is_last) counters[b] = 0u;  // every CTA of b has arrived
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* fb = feat + (size_t)b * D;
  if (D % 4 == 0 && ((reinterpret_cast<uintptr_t>(centers) |
                      reinterpret_cast<uintptr_t>(w)) % 16 == 0))
    probe_epilogue<4>(w, n_chunks, centers, fb, sep + b, best + b,
                      sims + (size_t)b * L, S, D, L, sm);
  else
    probe_epilogue<1>(w, n_chunks, centers, fb, sep + b, best + b,
                      sims + (size_t)b * L, S, D, L, sm);
}

// ------------------------------------------------ host side
template <typename T, int VEC, int BITS>
cudaError_t launch_row_pass(const RowArgs& a, cudaStream_t st) {
  // the group must hold the row: wpr * 32 lanes of kLaneElems elements
  if (a.wpr != 1 && a.wpr != 2 && a.wpr != kRowWarps) return cudaErrorInvalidValue;
  if (a.wpr * 32 * kLaneElems < a.D) return cudaErrorInvalidValue;
  const int ng = kRowWarps / a.wpr;
  const int n_chunks = (a.S + a.rows_per_cta - 1) / a.rows_per_cta;
  const size_t smem =
      (size_t)(ng * a.D > a.D + a.L ? ng * a.D : a.D + a.L) * sizeof(float);
  auto kernel = row_pass_kernel<T, VEC, BITS>;
  // once per kernel and device, before its first launch there: all of L1
  // as shared memory (3 CTAs an SM), and leave to use all of it.  Threads
  // that race here set the same values.
  static std::atomic<int> max_dyn[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int md = max_dyn[dev].load(std::memory_order_acquire);
  if (md == 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return e;
    md = optin - (int)fa.sharedSizeBytes;
    max_dyn[dev].store(md, std::memory_order_release);
  }
  if (smem > (size_t)md) return cudaErrorInvalidValue;
  kernel<<<dim3(n_chunks, a.B), kRowThreads, smem, st>>>(
      static_cast<const T*>(a.x), static_cast<uint8_t*>(a.payload),
      static_cast<float*>(a.scale), static_cast<float*>(a.zp),
      static_cast<float*>(a.ws), static_cast<unsigned*>(a.counters),
      static_cast<const float*>(a.centers), static_cast<float*>(a.feat),
      static_cast<float*>(a.sep), static_cast<int*>(a.best),
      static_cast<float*>(a.sims), a.S, a.D, a.L, a.rows_per_cta, a.wpr);
  return cudaGetLastError();
}

// K1 for activations of type T, loaded VEC elements at a time
template <typename T, int VEC>
cudaError_t rows_entry(const RowArgs& a, int bits, cudaStream_t st) {
  if (bits == 4) return launch_row_pass<T, VEC, 4>(a, st);
  if (bits == 8) return launch_row_pass<T, VEC, 8>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace
