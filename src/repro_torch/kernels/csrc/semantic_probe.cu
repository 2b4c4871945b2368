// K4 semantic_probe: GAP -> cosine against the label centers (Eq. 8) ->
// top-1 / top-2 -> separability (Eq. 9), for Hopper (sm_90a), one launch.
// Replaces the Pallas semantic_probe (_probe_kernel) of
// repro/kernels/semantic_cache.py.
//
// What bounds it: one read of x (B, S, D) and of the centers (L, D), an
// add a byte and 4 operations a center element: bytes through device
// memory at many rows; at serve's few rows (S = 8) the latency of two
// dependent loads (x, then the centers) and of the cross-CTA reduction.
//
// Design: a thread-block cluster of C = 8 CTAs a batch row (the largest
// portable cluster); no workspace, no arrival counter, no global atomics.
//   * CTA r owns a column slice of D: whole 16-byte vectors of x (4
//     float32 or 8 16-bit values; single elements on the scalar path),
//     nvec / C of them, the remainder in the last rank.  Its threads
//     split (row group, vector): G row groups of the slice's nv vectors,
//     G = min(512 / nv, S); the thread of group g sums rows g, g + G, ... in
//     order, kRowsAtOnce loads in flight before it adds any.  The groups'
//     sums are added in shared memory in group order, then divided by S:
//     the slice of f is fixed by the shape;
//   * from its slice of f and its slice of every center the CTA computes
//     2L + 1 partial sums (|f|^2, |c_l|^2, f . c_l) into its own shared
//     memory: each CTA reads 1/C of the centers;
//   * each CTA stores its partial sums into rank 0's shared memory
//     (distributed shared memory) and counts itself in on an mbarrier
//     there (a release arrive at cluster scope), then exits; rank 0 waits
//     on that mbarrier, adds the C partial vectors in rank order and
//     finishes as the fused boundary kernel's epilogue does (row_pass.cuh,
//     probe_epilogue): the cosine over max(|f|, 1e-12) and
//     max(|c|, 1e-12), Eq. 8, then top-1, top-2 and Eq. 9 sep as the
//     plain version takes them (probe_top2 in common.cuh: torch.argmax's
//     order, NaN carried).  The one cluster barrier (rank 0's mbarrier is
//     initialised before any rank stores there) is split: arrived at
//     first, waited on after the GAP.  Each cluster.sync() costs ~0.8 us
//     on an H100 (PERF.md), so rank 0 does not pull the partials
//     between two of them.
// The cluster size, and so the summation order, is fixed, so the outputs
// are the same bits on every call, capture and card.  Clusters of 16 (not
// portable) were measured too: 17% slower at (8, 4096, 2304), even or
// slower at 4 and 7 batch rows of 4096 tokens, ~5% faster at one, a shape
// no caller runs (PERF.md).

#include "common.cuh"

#include <cooperative_groups.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kProbeThreads = 512;
constexpr int kProbeWarps = kProbeThreads / 32;
constexpr int kRowsAtOnce = 16;  // rows a thread loads before adding
constexpr int kCluster = 8;  // CTAs a batch row
constexpr int kCenterLoads = 4;  // center loads a lane issues at a time
constexpr int kMaxDevices = 64;

// Shared memory (floats): rank 0's mbarrier (2 floats, padded to 4), the
// partials of every rank pc [kCluster][2L + 1] (filled in rank 0 by all ranks),
// sims [L], then the slice of f [W] and the row groups' sums [G * W],
// 16-byte aligned.  The same layout in every CTA of a launch.
__host__ __device__ __forceinline__ int probe_fs_offset(int L) {
  return (4 + kCluster * (2 * L + 1) + L + 3) & ~3;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The split cluster barrier: arrive early, wait where it is needed
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Add the VE values at p to acc (16-byte vectors come in as raw bits, so
// the loads in flight hold 4 registers each)
template <typename T, int VE>
struct VecOf {
  using Raw = typename std::conditional<VE == 1, T, uint4>::type;
  __device__ static Raw load(const T* p) {
    if constexpr (VE == 1)
      return *p;
    else
      return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void add(float* acc, Raw r) {
    float v[VE];
    if constexpr (VE == 1)
      v[0] = Elem<T>::widen(r);
    else
      Elem<T>::widen16(r, v);
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
  }
};

// CW consecutive floats of a center (CW == 4: one 16-byte load)
template <int CW>
__device__ __forceinline__ void load_center(const float* p, float* o) {
  if constexpr (CW == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

template <typename T, int VE>
__global__ void __launch_bounds__(kProbeThreads, 1)
semantic_probe_kernel(const T* __restrict__ x,
                      const float* __restrict__ centers,
                      float* __restrict__ sep, int* __restrict__ best,
                      float* __restrict__ sims, int S, int D, int L) {
  constexpr int CW = VE == 1 ? 1 : 4;
  extern __shared__ __align__(16) float sm[];
  constexpr int C = kCluster;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int nvec = D / VE;
  const int q = nvec / C;
  const int v0 = rank * q;
  const int nv = rank == C - 1 ? nvec - v0 : q;  // this slice's vectors
  const int W = nv * VE;                         // and elements
  const int NP = 2 * L + 1;                      // partials a rank
  const uint32_t bar = smem_addr(sm);
  float* pc = sm + 4;
  float* sl = pc + C * NP;
  float* fs = sm + probe_fs_offset(L);
  float* part = fs + ((W + 3) & ~3);
  // rank 0's barrier counts the C ranks' partials in; the cluster
  // barrier, arrived at here and waited on before the first remote
  // store, makes its init visible to them
  if (rank == 0 && t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
                 "r"(C)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive();
  // the first loads of each warp's first center go out with the GAP's
  const int nc = W / CW;  // center loads of the slice
  float c0[kCenterLoads][CW];
  if (warp < L && nc > 0) {
    const float* cl = centers + (size_t)warp * D + (size_t)v0 * VE;
#pragma unroll
    for (int a = 0; a < kCenterLoads; ++a)
      load_center<CW>(cl + min(lane + 32 * a, nc - 1) * CW, c0[a]);
  }
  // ---- GAP of the slice
  const int ncol = min(nv, kProbeThreads);
  const int G = nv > 0 ? max(1, min(kProbeThreads / nv, S)) : 1;
  if (nv > 0 && t < G * ncol) {
    const int g = t / ncol;
    const T* xb = x + (size_t)b * S * D + (size_t)v0 * VE;
    for (int j = t - g * ncol; j < nv; j += ncol) {
      float acc[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[e] = 0.f;
      for (int s0 = g; s0 < S; s0 += G * kRowsAtOnce) {
        typename VecOf<T, VE>::Raw v[kRowsAtOnce];
#pragma unroll
        for (int i = 0; i < kRowsAtOnce; ++i)
          v[i] = VecOf<T, VE>::load(
              xb + (size_t)min(s0 + G * i, S - 1) * D + j * VE);
#pragma unroll
        for (int i = 0; i < kRowsAtOnce; ++i)
          if (s0 + G * i < S) VecOf<T, VE>::add(acc, v[i]);
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) part[g * W + j * VE + e] = acc[e];
    }
  }
  __syncthreads();
  const float sf = (float)S;
  for (int e = t; e < W; e += kProbeThreads) {
    float a = part[e];
    for (int g = 1; g < G; ++g) a = __fadd_rn(a, part[g * W + e]);
    fs[e] = __fdiv_rn(a, sf);
  }
  __syncthreads();
  // ---- partial sums of the slice, |f|^2, then |c_l|^2 and f . c_l,
  // stored into rank 0's pc[rank]
  cluster_wait();
  float* pr = cluster.map_shared_rank(pc, 0) + rank * NP;
  if (warp == 0) {
    float ss = 0.f;
    for (int e = lane; e < W; e += 32) ss = __fmaf_rn(fs[e], fs[e], ss);
    ss = warp_sum(ss);
    if (lane == 0) pr[0] = ss;
  }
  for (int l = warp; l < L; l += kProbeWarps) {
    const float* cl = centers + (size_t)l * D + (size_t)v0 * VE;
    float cs = 0.f, dt = 0.f;
    for (int i0 = lane; i0 < nc; i0 += 32 * kCenterLoads) {
      float c[kCenterLoads][CW];
      if (l == warp && i0 == lane) {
#pragma unroll
        for (int a = 0; a < kCenterLoads; ++a)
#pragma unroll
          for (int e = 0; e < CW; ++e) c[a][e] = c0[a][e];
      } else {
#pragma unroll
        for (int a = 0; a < kCenterLoads; ++a)
          load_center<CW>(cl + min(i0 + 32 * a, nc - 1) * CW, c[a]);
      }
#pragma unroll
      for (int a = 0; a < kCenterLoads; ++a)
        if (i0 + 32 * a < nc) {
#pragma unroll
          for (int e = 0; e < CW; ++e) {
            const float f = fs[(i0 + 32 * a) * CW + e];
            cs = __fmaf_rn(c[a][e], c[a][e], cs);
            dt = __fmaf_rn(f, c[a][e], dt);
          }
        }
    }
    cs = warp_sum(cs);
    dt = warp_sum(dt);
    if (lane == 0) {
      pr[1 + 2 * l] = cs;
      pr[2 + 2 * l] = dt;
    }
  }
  // count this CTA in at rank 0 (release: its stores above go first);
  // every rank but 0 is then done
  __syncthreads();
  if (t == 0) {
    uint32_t rbar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(rbar) : "r"(bar));
    asm volatile("fence.acq_rel.cluster;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
            rbar)
        : "memory");
  }
  if (rank != 0) return;
  // ---- rank 0: the C partials in rank order, then the epilogue
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], 0;\n\t"
      "@!p bra WAIT;\n\t}" ::"r"(bar)
      : "memory");
  for (int l = t; l < L; l += kProbeThreads) {
    float ss = pc[0], cs = pc[1 + 2 * l], dt = pc[2 + 2 * l];
    for (int r = 1; r < C; ++r) {
      ss = __fadd_rn(ss, pc[r * NP]);
      cs = __fadd_rn(cs, pc[r * NP + 1 + 2 * l]);
      dt = __fadd_rn(dt, pc[r * NP + 2 + 2 * l]);
    }
    // cos = (f . c) / max(|f|, 1e-12) / max(|c|, 1e-12), then Eq. 8
    const float fnorm = fmaxf(__fsqrt_rn(ss), 1e-12f);
    const float cnorm = fmaxf(__fsqrt_rn(cs), 1e-12f);
    const float s = __fmul_rn(
        __fadd_rn(__fdiv_rn(__fdiv_rn(dt, fnorm), cnorm), 1.f), 0.5f);
    sl[l] = s;
    sims[(size_t)b * L + l] = s;
  }
  __syncthreads();
  if (warp == 0) probe_top2(sl, L, sep + b, best + b);
}

// ------------------------------------------------ host side
// Dynamic shared memory of a launch, in bytes (the last rank's slice is
// the widest).
size_t probe_smem(int D, int L, int VE) {
  const int nvec = D / VE;
  const int widest = nvec - (kCluster - 1) * (nvec / kCluster);
  const int W = ((widest * VE + 3) & ~3);
  // the row groups' sums: G * nv <= 512 vectors, or nv when wider
  const int parts = widest > kProbeThreads ? widest : kProbeThreads;
  return sizeof(float) *
         ((size_t)probe_fs_offset(L) + W + (size_t)parts * VE);
}

template <typename T, int VE>
cudaError_t launch_probe(const void* x, const void* centers, void* sep,
                         void* best, void* sims, int B, int S, int D, int L,
                         cudaStream_t st) {
  auto kernel = semantic_probe_kernel<T, VE>;
  // once per device, before the first launch there: leave to use all of
  // the dynamic shared memory
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
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return e;
    md = optin - (int)fa.sharedSizeBytes;
    max_dyn[dev].store(md, std::memory_order_release);
  }
  const size_t smem = probe_smem(D, L, VE);
  if (smem > (size_t)md) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B, 1);
  cfg.blockDim = dim3(kProbeThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                         static_cast<const float*>(centers),
                         static_cast<float*>(sep), static_cast<int*>(best),
                         static_cast<float*>(sims), S, D, L);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_probe_t(const void* x, const void* centers, void* sep,
                           void* best, void* sims, int B, int S, int D, int L,
                           cudaStream_t st) {
  // 16-byte loads of x and of the centers need D % kVec == 0 and aligned
  // pointers; single elements otherwise (odd widths, unaligned rows)
  if (D % Elem<T>::kVec == 0 && aligned(x, 16) && aligned(centers, 16))
    return launch_probe<T, Elem<T>::kVec>(x, centers, sep, best, sims, B, S,
                                          D, L, st);
  return launch_probe<T, 1>(x, centers, sep, best, sims, B, S, D, L, st);
}

}  // namespace

// x (B, S, D) of `dtype` (enum DType), centers (L, D) float32 -> sep (B,),
// best (B,) int32, sims (B, L), in one launch of B clusters of kCluster
// CTAs on `stream`.
extern "C" int coach_semantic_probe(const void* x, const void* centers,
                                    void* sep, void* best, void* sims, int B,
                                    int S, int D, int L, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || D <= 0 || L <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return (int)launch_probe_t<float>(x, centers, sep, best, sims, B, S, D,
                                        L, st);
    case kBF16:
      return (int)launch_probe_t<__nv_bfloat16>(x, centers, sep, best, sims, B,
                                                S, D, L, st);
    case kF16:
      return (int)launch_probe_t<__half>(x, centers, sep, best, sims, B, S, D,
                                         L, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
