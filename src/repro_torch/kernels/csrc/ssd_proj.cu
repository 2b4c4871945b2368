// Hopper (sm_90a) kernels of a mamba2 block's projections at few rows
// (K6): the five input projections (in_z, in_x, in_B, in_C, in_dt) in one
// launch, ssd_in_proj, and out_proj in another, ssd_out_proj.  Both are
// fp32 products y = x . W of at most 16 rows of x against weights stored
// row-major as (in, out), as models/ssm.py holds them.
//
// It replaces no Pallas kernel: the JAX package leaves these dots to XLA.
// The port ran them through cuBLAS, which at 8 rows sees the column-major
// C^T = W^T x^T (m = 1536, n = 8) and takes a 32 x 128 tile: 15/16 of
// each tile's FMAs are padding, and 48 CTAs or fewer run on 132 SMs, so
// each product is bound by computing padding (on an H100 at 8 rows: 128
// us for the five input projections, 8.3 us for out_proj).
//
// What bounds it: the bytes of the weights.  At up to 16 rows each weight
// element (4 bytes) takes part in at most 16 FMAs, 8 flops a byte, under
// the card's fp32 ridge of 67 TFLOP/s over 3.35 TB/s (20 a byte): a call
// is bound by reading its weights once.  At mamba2-130m's widths that is
// 10.3 MB for the five input projections and 4.7 MB for out_proj, 3.07
// and 1.41 us at 3.35 TB/s.  The design streams them:
//   * a CTA of 256 threads owns a tile of 4 L columns of one weight (L =
//     2 or 4 lanes a weight row, 16 bytes a lane) and the whole
//     contraction; the grid covers the tiles of all the weights of a call
//     one after another, each weight read where it lies (no concatenated
//     copy), each output written where the caller wants it;
//   * the CTA first copies the rows of x into shared memory (zero rows up
//     to the next of 4, 8 or 16), then each thread copies its 12 weight
//     rows (16 bytes each) into its own slots of shared memory: cp.async,
//     not through registers or L1 (a call reads its weights once), a copy
//     group a row, so the CTA's whole tile is in flight at once and the
//     thread does a row's FMAs as soon as that row lands; each weight
//     element is read from memory once and used for every row of x;
//   * the contraction is split across the CTA's threads, 256 / L rows of
//     W a step; a thread's partial sums are added over the lanes that
//     share its columns by a butterfly of warp shuffles (each step a lane
//     keeps half of its values and adds its partner's copy of that half),
//     then over the 8 warps in shared memory, warp 0 first: no atomics,
//     the same order at every call, so the bits repeat from replay to
//     replay;
//   * the widths' ragged ends (in_dt's 24 columns) are masked per lane;
//   * L is 4 where the 16-column tiles give every SM a CTA (the five
//     input projections: 210 CTAs), else 2 (out_proj: 96 CTAs of 8
//     columns); a wider tile reads longer runs of a weight row and copies
//     x to fewer CTAs.  Measured at 1, 8 and 16 rows on an H100 (PERF.md,
//     K6), this rule picked the fastest of 1, 2 and 4 lanes each time.
//     Contractions split across the CTAs of a cluster (adding through
//     distributed shared memory) measured slower at every tile.
//
// Numerics: fp32 FMAs throughout, no tensor core and no TF32; the sums
// run in another order than cuBLAS's.

#include "common.cuh"

#include <limits.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsEach = 12;  // weight rows a thread has in flight
constexpr int kMaxSegs = 5;    // weights a launch
constexpr int kMaxM = 16;      // rows of x
constexpr int kSMs = 132;      // an H100's
constexpr size_t kSmemDefault = 48 * 1024;  // above it, an opt-in

struct ProjSeg {
  const float* w;  // (K, n), row-major
  float* out;      // (M, n), row-major
  int n;           // columns, a multiple of 4
  int first;       // the segment's first CTA
};

struct ProjArgs {
  const float* x;  // (M, K), row-major
  ProjSeg seg[kMaxSegs];
  int nseg, M, K;
};

// 16 bytes from device memory into shared memory, or 16 zeros where
// bytes is 0, not through registers or L1.
__device__ __forceinline__ void copy16(float4* dst, const void* src,
                                       int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// Waits until at most `pending` of this thread's newest copy groups are
// pending (a constant where the call is unrolled, up to N).
template <int N = 15>
__device__ __forceinline__ void wait_groups(int pending) {
  if constexpr (N > 0) {
    if (pending < N) return wait_groups<N - 1>(pending);
  }
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Sums v over the 2^STEPS lanes that differ in lane bits off, 2 off, ...:
// at each step a lane keeps the half of its values that its bit selects
// (the upper half where the bit is set) and adds its partner's copy of
// that half, so v[0, 2 HALF >> STEPS) ends up holding sums over all of
// them.  Each sum is taken by one lane, in a fixed order.
template <int HALF, int STEPS>
__device__ __forceinline__ void butterfly(float* v, int lane, int off) {
  if constexpr (STEPS > 0) {
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = up ? v[i] : v[i + HALF];
      const float keep = up ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
    butterfly<HALF / 2, STEPS - 1>(v, lane, 2 * off);
  }
}

// MT: rows of x the CTA computes (M of them real, the rest zeros); L:
// lanes a weight row.
template <int MT, int L>
__global__ void __launch_bounds__(kThreads, MT <= 8 ? 2 : 1)
    ssd_proj_kernel(const ProjArgs a) {
  constexpr int kCols = 4 * L;         // the CTA's columns
  constexpr int kRows = kThreads / L;  // weight rows the CTA takes a step
  constexpr int kSteps = L == 2 ? 4 : 3;  // log2(32 / L)
  constexpr int kVals = 4 * MT;  // a thread's sums: MT rows x 4 columns
  constexpr int kKept = kVals >> kSteps;  // ... after the butterfly
  static_assert(L == 2 || L == 4, "2 or 4 lanes a row");
  static_assert(kKept >= 1, "fewer sums than lanes to share them");
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);  // (MT, K), then the sums

  const float* w = a.seg[0].w;
  float* out = a.seg[0].out;
  int n = a.seg[0].n, first = 0;
#pragma unroll
  for (int j = 1; j < kMaxSegs; ++j)
    if (j < a.nseg && (int)blockIdx.x >= a.seg[j].first) {
      w = a.seg[j].w;
      out = a.seg[j].out;
      n = a.seg[j].n;
      first = a.seg[j].first;
    }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = ((int)blockIdx.x - first) * kCols;
  const int col = col0 + 4 * (tid % L);
  const int row = tid / L;
  const bool live = col < n;  // n % 4 == 0: a lane's 4 columns in or out
  const int M = a.M, K = a.K;
  const int xs_floats = MT * K > kWarps * L * kVals ? MT * K
                                                   : kWarps * L * kVals;
  float4* wsm = smem + (xs_floats + 3) / 4;  // (kRowsEach, kThreads)

  float acc[kVals];  // acc[4 m + c]: row m, column col + c
#pragma unroll
  for (int i = 0; i < kVals; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kRows * kRowsEach) {
    if (k0 == 0) {
      // x into shared memory, the first copy group
      const int k4 = K / 4;
      const float4* x4 = reinterpret_cast<const float4*>(a.x);
      for (int i = tid; i < MT * k4; i += kThreads)
        copy16(smem + i, i < M * k4 ? x4 + i : x4, i < M * k4 ? 16 : 0);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    // each thread's weight rows into its own slots, a copy group a row
#pragma unroll
    for (int u = 0; u < kRowsEach; ++u) {
      const int k = k0 + row + u * kRows;
      const bool ok = live && k < K;
      copy16(wsm + u * kThreads + tid, ok ? w + (size_t)k * n + col : w,
             ok ? 16 : 0);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    if (k0 == 0) {
      wait_groups(kRowsEach);  // x, which every thread reads
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kRowsEach; ++u) {
      const int k = k0 + row + u * kRows;
      wait_groups(kRowsEach - 1 - u);  // this thread's row u
      if (k < K) {
        const float4 wq = wsm[u * kThreads + tid];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m * K + k];
          acc[4 * m + 0] = fmaf(xv, wq.x, acc[4 * m + 0]);
          acc[4 * m + 1] = fmaf(xv, wq.y, acc[4 * m + 1]);
          acc[4 * m + 2] = fmaf(xv, wq.z, acc[4 * m + 2]);
          acc[4 * m + 3] = fmaf(xv, wq.w, acc[4 * m + 3]);
        }
      }
    }
  }

  // over the warp's lanes of one column group: acc[0, kKept) then holds
  // its sums of values base .. base + kKept - 1
  butterfly<kVals / 2, kSteps>(acc, lane, L);
  int base = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    if (lane & (L << s)) base += kVals >> (s + 1);
  __syncthreads();  // every warp is done with xs
  float* red = xs;  // (kWarps, L, kVals): each warp's sums
#pragma unroll
  for (int i = 0; i < kKept; ++i)
    red[(warp * L + tid % L) * kVals + base + i] = acc[i];
  __syncthreads();
  // over the warps, warp 0 first
  for (int t = tid; t < MT * kCols; t += kThreads) {
    const int m = t / kCols, c = t % kCols;
    if (m < M && col0 + c < n) {
      const float* r = red + (c / 4) * kVals + 4 * m + c % 4;
      float s = r[0];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) s += r[v * L * kVals];
      out[(size_t)m * n + col0 + c] = s;
    }
  }
}

template <int MT, int L>
cudaError_t launch_tile(const ProjArgs& a, int ctas, cudaStream_t st) {
  // x (or the warps' sums), then the weight rows
  const size_t xs = (size_t)MT * a.K * sizeof(float);
  const size_t red = (size_t)kWarps * L * 4 * MT * sizeof(float);
  const size_t smem = ((xs > red ? xs : red) + 15) / 16 * 16 +
                      (size_t)kRowsEach * kThreads * sizeof(float4);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_proj_kernel<MT, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ssd_proj_kernel<MT, L><<<ctas, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// rows of x padded to 4, 8 or 16
template <int L>
cudaError_t launch_rows(const ProjArgs& a, int ctas, cudaStream_t st) {
  if (a.M <= 4) return launch_tile<4, L>(a, ctas, st);
  if (a.M <= 8) return launch_tile<8, L>(a, ctas, st);
  return launch_tile<16, L>(a, ctas, st);
}

int count_tiles(const int* ns, int nseg, int cols) {
  int t = 0;
  for (int j = 0; j < nseg; ++j) t += (ns[j] + cols - 1) / cols;
  return t;
}

}  // namespace

// x (M, K) . w_j (K, n_j) -> out_j (M, n_j) for j < nseg: one launch on
// `stream`, fp32, contiguous row-major tensors, 16-byte aligned, 1 <= M <=
// 16, K and every n_j multiples of 4.  Allocates nothing, does not
// synchronize; returns the launch's error (0 on success).
extern "C" int coach_ssd_proj(const void* x, const void* const* ws,
                              void* const* outs, const int* ns, int nseg,
                              int M, int K, void* stream) {
  if (nseg < 1 || nseg > kMaxSegs || M < 1 || M > kMaxM || K < 4 ||
      K % 4 != 0)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < nseg; ++j)
    if (ns[j] < 4 || ns[j] % 4 != 0 || ns[j] > INT_MAX / K)
      return (int)cudaErrorInvalidValue;
  const int lanes = count_tiles(ns, nseg, 16) >= kSMs ? 4 : 2;
  ProjArgs a{};
  a.x = static_cast<const float*>(x);
  a.nseg = nseg;
  a.M = M;
  a.K = K;
  int first = 0;
  for (int j = 0; j < nseg; ++j) {
    a.seg[j] = ProjSeg{static_cast<const float*>(ws[j]),
                       static_cast<float*>(outs[j]), ns[j], first};
    first += (ns[j] + 4 * lanes - 1) / (4 * lanes);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(lanes == 4 ? launch_rows<4>(a, first, st)
                          : launch_rows<2>(a, first, st));
}
