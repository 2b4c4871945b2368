// Hopper (sm_90a) kernels of the mamba2 SSD mixer (K5): everything of a
// mamba2 block between its five input projections and out_proj, that is
// models/ssm.py's plain chain _causal_conv (x, B, C), softplus, the
// chunked scan ssd_chunked (_chunk_terms, _recurrence, _chunk_out), the D
// skip and _gated_norm, in three launches a layer (four when a state is
// carried between chunks, given or returned).
//
// It replaces no Pallas kernel: the JAX package writes the chain in jnp
// and XLA fuses it, while the port ran it op by op, one ATen kernel an op
// (~90 a layer, ~2300 a mamba2-130m task inside its CUDA graphs).
//
// What bounds it: at the served shapes (one batch row, S <= 128 tokens,
// 24 heads of P = 64, state N = 128) the work is small (a chunk's
// quadratic term is ~13 M FMAs, the bytes ~2 MB, all in L2), so each
// launch is bound by its latency: the chain of dependent steps of one CTA,
// and the launches themselves.  The design keeps the launches few and
// spreads each over the card:
//   * ssd_prep: C.B^T (shared by the heads: SSM_GROUPS = 1) in 16 x 16
//     tiles on and below the diagonal, a CTA a tile, each from its own
//     conv of the tile's C and B rows (K taps, zero before the start,
//     bias, SiLU); the diagonal tiles, which convolve each 16 rows of B
//     and C once, also write them to fp32 workspaces for the state
//     kernel; a warp a (batch row, chunk, head) for dt = softplus(dt +
//     dt_bias) and the within-chunk inclusive cumsum of dt * A (a lane
//     scans ceil(Q / 32) steps, then a shuffle scan of the lanes'
//     totals); and a thread a (token, channel) of the conv over x; the
//     workspaces hold the chunks' padding steps as 0;
//   * ssd_chunk: a CTA a (batch row, chunk, head, 32 rows of the chunk).
//     It walks the 32-wide column blocks up to the diagonal: CB weighed
//     by the decay exp(cum_i - cum_j) for i >= j and 0 above, then
//     Yd += (CB o L) . (x dt) in registers, the next block's loads in
//     flight meanwhile; then y = Yd + D x for its rows;
//   * ssd_state (only when needed): a CTA a (batch row, head, 8 head
//     dims) holds its slice of the state in registers and walks the
//     chunks: Yo = exp(cum_i) C_i . h_in added into y, the chunk's state
//     term B^T (x dt exp(cum_last - cum)), h = h exp(cum_last) + Sc, and
//     writes hT;
//   * gated_rmsnorm: a CTA a token row: y silu(z), the mean square over
//     the row (a fixed-order block sum), x rsqrt(. + eps) x norm_scale.
// The chunk length Q = min(ssm_chunk, S) and the dt = 0 padding of the
// last chunk are ssd_chunked's, so the plain chain checks the kernels.
//
// Numerics: fp32 throughout (bfloat16 / float16 inputs widened, outputs
// rounded to nearest even once at the end), with fp32 FMAs: no tensor
// core and no TF32.  Build without --use_fast_math (expf, log1pf and the
// divisions are the accurate ones).  The elementwise steps round where
// the plain chain rounds; sums run in another order than ATen's.

#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kP = 64;       // head dim
constexpr int kN = 128;      // state size
constexpr int kMaxQ = 256;   // chunk length at most
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTI = 32;      // rows and columns of a chunk tile
constexpr int kTB = 16;      // rows and columns of a C.B^T tile
constexpr int kLd = kN + 4;  // padded row of a B / C tile (16-byte rows)
constexpr int kPT = 8;       // head dims of a state tile

// Arguments of every launch; activations and parameters of type T except
// a_log, d_skip and dt_bias (fp32); workspaces fp32.
struct SsdArgs {
  const void *z, *xr, *br, *cr, *dt;        // (B,S,di) x2, (B,S,N) x2, (B,S,H)
  const void *wx, *wb, *wc, *bx, *bb, *bc;  // conv (K,di) (K,N) (K,N), biases
  const void* norm_scale;                   // (di)
  const float *a_log, *d_skip, *dt_bias;    // (H)
  const void* h0;                           // (B,H,P,N) or null
  float *xs, *bs, *cs;                      // (B,Sp,di), (B,Sp,N) x2
  float *dts, *cum;                         // (B,H,Sp)
  float* cb;                                // (B,nc,Q,Q): C.B^T, i >= j
  float* y;                                 // (B,S,di)
  void *out, *hT;                           // (B,S,di), (B,H,P,N) or null
  int B, S, Q, nc, H, K;
  float eps;
};

__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// torch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One output of the conv over stream `src` (width channels): channel c of
// token t, the K taps over tokens t - K + 1 .. t (zero before the start),
// bias, SiLU; 0 for a padding step t >= S.
template <typename T>
__device__ __forceinline__ float conv1(const T* src, const T* w,
                                       const T* bias, int width, int c,
                                       int b, int t, int S, int K) {
  if (t >= S) return 0.f;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int s = t - (K - 1) + k;
    const float xv =
        s >= 0 ? Elem<T>::widen(src[((long long)b * S + s) * width + c]) : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(xv, Elem<T>::widen(w[k * width + c])));
  }
  return silu(__fadd_rn(acc, Elem<T>::widen(bias[c])));
}

// Rows r0 .. r0 + 15 of chunk c of a B or C stream (kN channels), conv1's
// operations in its order, into tile[row][channel] (0 past the chunk);
// a thread takes one channel of 8 consecutive rows, its K - 1 + 8 input
// rows loaded at once and reused across the rows.
constexpr int kMaxK = 8;  // conv taps at most
constexpr int kRows = kTB * kN / kThreads;  // rows a thread, 8
template <typename T>
__device__ __forceinline__ void conv_tile(const T* __restrict__ src,
                                          const T* __restrict__ w,
                                          const T* __restrict__ bias,
                                          float (*tile)[kLd], int b, int c,
                                          int r0, const SsdArgs& a) {
  const int n = threadIdx.x % kN, rr = threadIdx.x / kN * kRows;
  const int t0 = c * a.Q + r0 + rr;  // the token of this thread's first row
  float raw[kRows + kMaxK - 1], wk[kMaxK];
#pragma unroll
  for (int k = 0; k < kRows + kMaxK - 1; ++k) {
    const int s = t0 - (a.K - 1) + k;
    raw[k] = k < kRows + a.K - 1 && s >= 0 && s < a.S
                 ? Elem<T>::widen(src[((long long)b * a.S + s) * kN + n])
                 : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    wk[k] = k < a.K ? Elem<T>::widen(w[k * kN + n]) : 0.f;
  const float bn = Elem<T>::widen(bias[n]);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < a.K) acc = __fadd_rn(acc, __fmul_rn(raw[r + k], wk[k]));
    const int i = r0 + rr + r;
    tile[rr + r][n] =
        i < a.Q && t0 + r < a.S ? silu(__fadd_rn(acc, bn)) : 0.f;
  }
}

// ------------------------------------------------ ssd_prep
// Three roles, by block: [0, cb_blocks) a 16 x 16 tile (i >= j blocks) of
// a chunk's C.B^T, from its own conv of the tile's C and B rows (the
// longest role, so it is scheduled first), a thread an element, the
// diagonal tiles writing their B and C rows for the state kernel; then
// the dt scan, a warp a (b, chunk, head); then the conv over x, a block a
// token row (or kThreads channels of it), a thread a channel, written for
// the chunk and state kernels and the D skip.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_prep_kernel(const SsdArgs a, int cb_blocks, int scan_blocks) {
  __shared__ __align__(16) float cs[kTB][kLd];
  __shared__ __align__(16) float bs[kTB][kLd];
  const int Sp = a.nc * a.Q, di = a.H * kP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int blk = blockIdx.x;
  if (blk < cb_blocks) {
    const int nt = (a.Q + kTB - 1) / kTB, tiles = nt * (nt + 1) / 2;
    const int bc = blk / tiles;
    int ti = 0, k = blk % tiles;
    while (k > ti) k -= ++ti;  // row ti of the lower triangle, column k
    const int b = bc / a.nc, c = bc % a.nc;
    conv_tile(static_cast<const T*>(a.cr), static_cast<const T*>(a.wc),
              static_cast<const T*>(a.bc), cs, b, c, ti * kTB, a);
    conv_tile(static_cast<const T*>(a.br), static_cast<const T*>(a.wb),
              static_cast<const T*>(a.bb), bs, b, c, k * kTB, a);
    __syncthreads();
    if (ti == k) {  // rows ti * 16 .. of this chunk of B and C, once
      const long long row0 = (long long)b * Sp + c * a.Q + ti * kTB;
      for (int e = tid; e < kTB * kN; e += kThreads) {
        const int r = e / kN, n = e % kN;
        if (ti * kTB + r < a.Q) {
          a.bs[(row0 + r) * kN + n] = bs[r][n];
          a.cs[(row0 + r) * kN + n] = cs[r][n];
        }
      }
    }
    const int ir = tid / kTB, jr = tid % kTB;
    float cb = 0.f;
#pragma unroll 8
    for (int n = 0; n < kN; n += 4) {
      const float4 cv = ld4(&cs[ir][n]), bv = ld4(&bs[jr][n]);
      cb = fmaf(cv.x, bv.x, cb);
      cb = fmaf(cv.y, bv.y, cb);
      cb = fmaf(cv.z, bv.z, cb);
      cb = fmaf(cv.w, bv.w, cb);
    }
    const int i = ti * kTB + ir, j = k * kTB + jr;
    if (i < a.Q && j < a.Q) a.cb[((long long)bc * a.Q + i) * a.Q + j] = cb;
    return;
  }
  blk -= cb_blocks;
  if (blk < scan_blocks) {
    const int wid = blk * kWarps + warp;
    if (wid >= a.B * a.nc * a.H) return;  // a whole warp
    const int h = wid % a.H, c = (wid / a.H) % a.nc, b = wid / (a.H * a.nc);
    const float A = -expf(a.a_log[h]);
    const float bias = a.dt_bias[h];
    const T* dt = static_cast<const T*>(a.dt);
    const long long head = ((long long)b * a.H + h) * Sp;
    const int R = (a.Q + 31) >> 5;  // steps a lane, at most 8
    float v[8];
    float run = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = lane * R + r;
      float d = 0.f;
      if (r < R && i < a.Q) {
        const int t = c * a.Q + i;
        if (t < a.S)
          d = softplus(__fadd_rn(
              Elem<T>::widen(dt[((long long)b * a.S + t) * a.H + h]), bias));
        a.dts[head + t] = d;
      }
      run = __fadd_rn(run, __fmul_rn(d, A));
      v[r] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, n);
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = lane * R + r;
      if (r < R && i < a.Q) a.cum[head + c * a.Q + i] = __fadd_rn(excl, v[r]);
    }
    return;
  }
  blk -= scan_blocks;
  const int per_row = (di + kThreads - 1) / kThreads;
  const int bt = blk / per_row, ch = blk % per_row * kThreads + tid;
  if (ch >= di) return;
  a.xs[(long long)bt * di + ch] =
      conv1(static_cast<const T*>(a.xr), static_cast<const T*>(a.wx),
            static_cast<const T*>(a.bx), di, ch, bt / Sp, bt % Sp, a.S, a.K);
}

// ------------------------------------------------ ssd_chunk
// Warp w owns rows i0 + 4w .. i0 + 4w + 3 of the tile.  In a column block
// lane l weighs column j0 + l of CB with the decay, and in Yd sums head
// dims 2l and 2l + 1.  The next block's CB and x dt are loaded into
// registers while this block's product runs.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const SsdArgs a) {
  __shared__ __align__(16) float xd[kTI][kP];
  __shared__ __align__(16) float ms[kTI][kTI + 4];  // [column][row]
  __shared__ float cums[kMaxQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = (a.Q + kTI - 1) / kTI;  // row tiles a chunk
  const int h = blockIdx.y, bc = blockIdx.x / nq, b = bc / a.nc,
            c = bc % a.nc;
  const int i0 = blockIdx.x % nq * kTI, Q = a.Q;
  if (c * Q + i0 >= a.S) return;  // padding rows only
  const int Sp = a.nc * Q, di = a.H * kP;
  const long long row0 = (long long)b * Sp + c * Q;  // the chunk's first row
  const float* cumh = a.cum + ((long long)b * a.H + h) * Sp + c * Q;
  const float* dth = a.dts + ((long long)b * a.H + h) * Sp + c * Q;
  const float* cbq = a.cb + (long long)bc * Q * Q;
  for (int i = tid; i < Q; i += kThreads) cums[i] = cumh[i];
  // a block's loads: CB[i][j0 + lane] for this warp's rows, x and dt of
  // the rows j0 + tid / 64 + 4 s at head dim tid % 64
  float cbr[4], xr[kTI * kP / kThreads], dr[kTI * kP / kThreads];
  auto load = [&](int j0) {
    const int j = j0 + lane;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 4 * warp + u;
      cbr[u] = j <= i && i < Q ? cbq[(long long)i * Q + j] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kTI * kP / kThreads; ++s) {
      const int r = tid / kP + s * (kThreads / kP), p = tid % kP;
      const bool in = j0 + r < Q;
      xr[s] = in ? a.xs[(row0 + j0 + r) * di + h * kP + p] : 0.f;
      dr[s] = in ? dth[j0 + r] : 0.f;
    }
  };
  load(0);
  float acc[4][2] = {};
  for (int j0 = 0; j0 <= i0; j0 += kTI) {
    __syncthreads();  // cums is loaded; the previous block's tiles are read
    const int j = j0 + lane;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 4 * warp + u;
      ms[lane][4 * warp + u] =
          j <= i && i < Q
              ? __fmul_rn(cbr[u], expf(__fsub_rn(cums[i], cums[j])))
              : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kTI * kP / kThreads; ++s)
      xd[tid / kP + s * (kThreads / kP)][tid % kP] = __fmul_rn(xr[s], dr[s]);
    __syncthreads();
    if (j0 + kTI <= i0) load(j0 + kTI);
#pragma unroll 8
    for (int jj = 0; jj < kTI; ++jj) {
      const float4 m4 = ld4(&ms[jj][4 * warp]);
      const float2 x2 = *reinterpret_cast<const float2*>(&xd[jj][2 * lane]);
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[u][0] = fmaf(mv[u], x2.x, acc[u][0]);
        acc[u][1] = fmaf(mv[u], x2.y, acc[u][1]);
      }
    }
  }
  const float dsk = a.d_skip[h];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + 4 * warp + u, t = c * Q + i;
    if (i < Q && t < a.S) {
      const float* xrow = a.xs + (row0 + i) * di + h * kP;
      float* yrow = a.y + ((long long)b * a.S + t) * di + h * kP;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int p = 2 * lane + v;
        yrow[p] = __fadd_rn(acc[u][v], __fmul_rn(dsk, xrow[p]));
      }
    }
  }
}

// ------------------------------------------------ ssd_state
// Thread (warp w, lane l) holds state[p0 + w][4l .. 4l + 3]; in Yo thread
// i takes row i of the chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(const SsdArgs a) {
  __shared__ __align__(16) float hs[kPT][kN];
  __shared__ float ws[kMaxQ][kPT];
  __shared__ float cums[kMaxQ];
  const int tid = threadIdx.x, pr = tid >> 5, n4 = 4 * (tid & 31);
  const int p0 = blockIdx.x % (kP / kPT) * kPT, h = blockIdx.y,
            b = blockIdx.x / (kP / kPT);
  const int Q = a.Q, Sp = a.nc * Q, di = a.H * kP;
  const long long srow = (((long long)b * a.H + h) * kP + p0 + pr) * kN + n4;
  float st[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.h0 != nullptr) {
    const T* h0 = static_cast<const T*>(a.h0);
#pragma unroll
    for (int k = 0; k < 4; ++k) st[k] = Elem<T>::widen(h0[srow + k]);
  }
  for (int c = 0; c < a.nc; ++c) {
    const long long row0 = (long long)b * Sp + c * Q;
    const float* cumh = a.cum + ((long long)b * a.H + h) * Sp + c * Q;
    const float* dth = a.dts + ((long long)b * a.H + h) * Sp + c * Q;
    __syncthreads();  // the previous chunk's reads are done
    *reinterpret_cast<float4*>(&hs[pr][n4]) =
        make_float4(st[0], st[1], st[2], st[3]);
    for (int i = tid; i < Q; i += kThreads) cums[i] = cumh[i];
    __syncthreads();
    const float last = cums[Q - 1];
    for (int e = tid; e < Q * kPT; e += kThreads) {
      const int j = e / kPT, p = e % kPT;
      ws[j][p] = __fmul_rn(
          __fmul_rn(a.xs[(row0 + j) * di + h * kP + p0 + p], dth[j]),
          expf(__fsub_rn(last, cums[j])));
    }
    if (c > 0 || a.h0 != nullptr) {
      for (int i = tid; i < Q; i += kThreads) {
        const int t = c * Q + i;
        if (t >= a.S) continue;
        float o[kPT] = {};
        const float* crow = a.cs + (row0 + i) * kN;
        for (int n = 0; n < kN; n += 4) {
          const float4 cv = ld4(crow + n);
#pragma unroll
          for (int p = 0; p < kPT; ++p) {
            const float4 hv = ld4(&hs[p][n]);
            o[p] = fmaf(cv.x, hv.x, o[p]);
            o[p] = fmaf(cv.y, hv.y, o[p]);
            o[p] = fmaf(cv.z, hv.z, o[p]);
            o[p] = fmaf(cv.w, hv.w, o[p]);
          }
        }
        const float dec = expf(cums[i]);
        float* yrow = a.y + ((long long)b * a.S + t) * di + h * kP + p0;
#pragma unroll
        for (int p = 0; p < kPT; ++p)
          yrow[p] = __fadd_rn(yrow[p], __fmul_rn(dec, o[p]));
      }
    }
    __syncthreads();  // ws is written
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < Q; ++j) {
      const float4 bv = ld4(a.bs + (row0 + j) * kN + n4);
      const float w = ws[j][pr];
      sc[0] = fmaf(bv.x, w, sc[0]);
      sc[1] = fmaf(bv.y, w, sc[1]);
      sc[2] = fmaf(bv.z, w, sc[2]);
      sc[3] = fmaf(bv.w, w, sc[3]);
    }
    const float decay = expf(last);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      st[k] = __fadd_rn(__fmul_rn(st[k], decay), sc[k]);
  }
  T* hT = static_cast<T*>(a.hT);
#pragma unroll
  for (int k = 0; k < 4; ++k) hT[srow + k] = Elem<T>::narrow(st[k]);
}

// ------------------------------------------------ gated_rmsnorm
// A row of di <= kThreads * kNormPer is read once into registers, its
// loads all in flight together; a wider one is read twice.
constexpr int kNormPer = 8;
template <typename T>
__global__ void __launch_bounds__(kThreads)
gated_rmsnorm_kernel(const SsdArgs a) {
  __shared__ float part[kWarps];
  const long long row = blockIdx.x;  // b * S + t
  const int di = a.H * kP, tid = threadIdx.x;
  const float* __restrict__ yr = a.y + row * di;
  const T* __restrict__ zr = static_cast<const T*>(a.z) + row * di;
  const T* __restrict__ scale = static_cast<const T*>(a.norm_scale);
  T* __restrict__ out = static_cast<T*>(a.out) + row * di;
  const bool held = di <= kThreads * kNormPer;
  float g[kNormPer];
  float ss = 0.f;
  if (held) {
#pragma unroll
    for (int u = 0; u < kNormPer; ++u) {
      const int c = tid + u * kThreads;
      g[u] = c < di ? __fmul_rn(yr[c], silu(Elem<T>::widen(zr[c]))) : 0.f;
      ss = fmaf(g[u], g[u], ss);
    }
  } else {
    for (int c = tid; c < di; c += kThreads) {
      const float v = __fmul_rn(yr[c], silu(Elem<T>::widen(zr[c])));
      ss = fmaf(v, v, ss);
    }
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) part[tid >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot = __fadd_rn(tot, part[w]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(tot, (float)di), a.eps));
  if (held) {
#pragma unroll
    for (int u = 0; u < kNormPer; ++u) {
      const int c = tid + u * kThreads;
      if (c < di)
        out[c] = Elem<T>::narrow(
            __fmul_rn(__fmul_rn(g[u], r), Elem<T>::widen(scale[c])));
    }
  } else {
    for (int c = tid; c < di; c += kThreads) {
      const float v = __fmul_rn(yr[c], silu(Elem<T>::widen(zr[c])));
      out[c] = Elem<T>::narrow(
          __fmul_rn(__fmul_rn(v, r), Elem<T>::widen(scale[c])));
    }
  }
}

template <typename T>
cudaError_t launch_ssd(const SsdArgs& a, bool state, cudaStream_t st) {
  const long long Sp = (long long)a.nc * a.Q;
  const int nt = (a.Q + kTB - 1) / kTB;
  const long long cb_blocks = (long long)a.B * a.nc * nt * (nt + 1) / 2;
  const long long scan_blocks =
      ((long long)a.B * a.nc * a.H + kWarps - 1) / kWarps;
  const long long conv_blocks =
      a.B * Sp * ((a.H * kP + kThreads - 1) / kThreads);
  const long long blocks = cb_blocks + scan_blocks + conv_blocks;
  const long long chunk_blocks =
      (long long)a.B * a.nc * ((a.Q + kTI - 1) / kTI);
  if (blocks > INT_MAX || chunk_blocks > INT_MAX ||
      (long long)a.B * (kP / kPT) > INT_MAX || (long long)a.B * a.S > INT_MAX)
    return cudaErrorInvalidValue;
  ssd_prep_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      a, (int)cb_blocks, (int)scan_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_chunk_kernel<T><<<dim3((unsigned)chunk_blocks, a.H), kThreads, 0,
                        st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (state) {
    ssd_state_kernel<T><<<dim3(kP / kPT * a.B, a.H), kThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  gated_rmsnorm_kernel<T><<<(unsigned)((long long)a.B * a.S), kThreads, 0,
                            st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The SSD mixer of one mamba2 block: launches ssd_prep, ssd_chunk,
// ssd_state when `state` (then hT is written, from h0 when it is not
// null) and gated_rmsnorm on `stream`, allocates nothing, does not
// synchronize, and returns the first launch's error (0 on success).
// Tensors are contiguous; head dim 64, state 128, one B/C group; dtype
// (enum DType) is that of the activations, conv weights and biases,
// norm_scale, h0, out and hT; a_log, d_skip, dt_bias are fp32.  The
// workspaces hold nc * Q steps a batch row.
extern "C" int coach_ssd_mixer(
    const void* z, const void* xr, const void* br, const void* cr,
    const void* dt, const void* wx, const void* wb, const void* wc,
    const void* bx, const void* bb, const void* bc, const void* norm_scale,
    const void* a_log, const void* d_skip, const void* dt_bias,
    const void* h0, void* xs, void* bs, void* cs, void* dts, void* cum,
    void* cb, void* y, void* out, void* hT, int B, int S, int Q, int H, int K,
    int state, int dtype, float eps, void* stream) {
  if (B <= 0 || S <= 0 || Q <= 0 || Q > kMaxQ || H <= 0 || H > 65535 ||
      K <= 0 || K > kMaxK || (state && hT == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  const SsdArgs a{z,
                  xr,
                  br,
                  cr,
                  dt,
                  wx,
                  wb,
                  wc,
                  bx,
                  bb,
                  bc,
                  norm_scale,
                  static_cast<const float*>(a_log),
                  static_cast<const float*>(d_skip),
                  static_cast<const float*>(dt_bias),
                  h0,
                  static_cast<float*>(xs),
                  static_cast<float*>(bs),
                  static_cast<float*>(cs),
                  static_cast<float*>(dts),
                  static_cast<float*>(cum),
                  static_cast<float*>(cb),
                  static_cast<float*>(y),
                  out,
                  hT,
                  B,
                  S,
                  Q,
                  nc,
                  H,
                  K,
                  eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)launch_ssd<float>(a, state != 0, st);
    case kBF16:
      return (int)launch_ssd<__nv_bfloat16>(a, state != 0, st);
    case kF16:
      return (int)launch_ssd<__half>(a, state != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
