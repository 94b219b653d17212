// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package's
// deeplearning4j_tpu/ops/pallas/flash_attention.py: _flash_bwd (dq
// pallas_call at :633, kernel _bwd_dq_kernel :243; dk/dv pallas_call at
// :655, kernel _bwd_dkv_kernel :286) AND _flash_bwd_chunked (:542, :575),
// which the JAX package takes past T = 8192 only because VMEM cannot hold
// the whole K/V (dq pass) or Q/dO (dk/dv pass) of a (batch, head) there.
// These kernels stream every tile from global memory at any length, so the
// one pair computes both rows; the chunked regime is checked at T = 16384.
//
// Given q, k, v, the forward's o and lse (per-row logsumexp, fp32) and dO,
// per (batch, head), with S = Q K^T * scale + bias [+ causal]:
//   delta = rowsum(dO * O)                            (fp32; the dq kernel's
//                                                      prologue, stored for the
//                                                      dk/dv kernel)
//   P     = exp(S - lse)
//   dP    = dO V^T
//   dS    = P * (dP - delta) * scale, rounded to T
//   dQ    = dS K            (dq kernel: a block per query tile, looping over
//                            key tiles up to the causal diagonal)
//   dV    = round(P)^T dO,  dK = dS^T Q
//                           (dk/dv kernel: a block per key tile, looping over
//                            query tiles from the causal diagonal on)
// with every product read from T operands and summed in fp32, and dQ, dK, dV
// stored in T. Launch the dq kernel first, on the same stream: the dk/dv
// kernel reads its delta. Two kernels that each recompute S, as the two
// pallas_calls do, and no atomics: every gradient is the same bit for bit
// from launch to launch.
//
// Semantics, as the Pallas kernels' (and as flash_fwd.cu's forward):
//   - bias is the additive key-padding bias (B, t_k) fp32 (0 or -1e30),
//     shared by the heads of a batch row;
//   - causal is the top-left triangle (key <= query), t_q == t_k; keys past
//     t_k and above the diagonal weigh exactly 0;
//   - a FULLY MASKED row (every key biased by -1e30): its scores are -1e30
//     exactly in fp32 and so is its lse (-1e30 + log(t_k) rounds back to
//     -1e30), so P = exp(0) = 1 for every key, not 1/t_k. The Pallas backward
//     computes the same, and so do these kernels and the plain version
//     (flash_attention_backward_reference): the port holds the JAX kernel's
//     result, not the gradient of the dense softmax.
// Ragged t_q and t_k >= 1, d and d_v (which may differ) 1..256, T float or
// bf16; anything else is refused with cudaErrorInvalidValue.
//
// Layout: q, k, v, o, dO, dq, dk and dv are read and written through
// (batch, head, time) strides in elements with a unit stride along d, so
// the caller's (b, t, h, d) buffers are used without transposing them.
//
// Bounds on an H100 (3.35 TB/s, 989 TFLOP/s bf16). BERT-base training
// shape (B=64, h=12, T=128, d=64, bf16): the pair reads q, k, v, o, dO and
// writes dq, dk, dv, 8 x 12.6 MB = 101 MB, 0.0302 ms, against 5 products of
// 2 x 768 x 128^2 x 64 FLOP (S and dP in both kernels count once each),
// 8.1 GFLOP, 0.008 ms: bytes. T=4096 causal (B=1, h=12, d=64): 64.4 GFLOP
// of products over the attended pairs, 0.0652 ms, against 50 MB, 0.015 ms:
// operations.
//
// Design, bf16 with d and d_v up to 128 (flash_bwd_dq_kernel_mma,
// flash_bwd_dkv_kernel_mma, on the tile machinery of attention_mma.cuh):
// blocks of 4 warps, each warp 16 rows, every product on mma.sync m16n8k16
// (bf16 operands, fp32 sums), operands staged as bf16 rows padded to a
// multiple of 16 columns with zeros, by 16-byte cp.async where every row
// starts on a 16-byte boundary (VEC, chosen by the launcher and re-checked
// here) and element by element into the same layout otherwise.
//   - dq: a block owns 64 query rows. Q, dO and O are staged once (O in the
//     last V stage, before the ring needs it); the prologue forms delta
//     (two lanes a row, fp32) and stores it. K/V tiles of 64 keys walk up to
//     the causal diagonal in a cp.async ring (3 stages at heads up to 64
//     wide, 2 above, for shared memory), the next tiles in flight while one
//     is multiplied. Per tile S = Q K^T and dP = dO V^T (warp_scores), P
//     and dS in registers, then dQ += dS K (warp_pv: dS from scores_to_a,
//     K through ldmatrix.trans). dQ stays in registers and is stored once.
//   - dk/dv: a block owns 64 keys. K and V are staged once; query tiles (64
//     rows, 32 at widths above 64 so that the accumulators fit in
//     registers) walk from the causal diagonal on in a ring of Q, dO and
//     the rows' lse and delta (4-byte cp.async), staged alike. The transposed
//     tiles S^T = K Q^T and dP^T = V dO^T (K and V as the A operand) put
//     P^T and dS^T in registers as A fragments, so dV += round(P^T) dO and
//     dK += dS^T Q are warp_pv products with dO and Q through
//     ldmatrix.trans: nothing goes through shared memory. lse and delta
//     are per column there, read from the ring's copy for the query
//     columns a thread holds; the bias is per row (key), loaded once.
//   - exp: exp_approx(x - lse), the difference formed first (never FA2's
//     fused x log2e - lse log2e), so a fully masked row (x = lse = -1e30)
//     still gets exactly exp(0) = 1. dS is rounded to bf16 (nearest even)
//     before both of its products, P before P^T dO: the plain version's
//     points.
// Widths above 128: dK + dV of 16 keys x 256 columns do not fit in a
// warp's registers, so the C dispatch takes the CUDA-core kernels below for
// bf16 at d or d_v above 128, by width alone (no try-and-fall-back).
//
// float32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel: the card's check of
// the algorithm, and bf16 past 128): 256 threads, CUDA-core products in
// fp32 from shared memory. Tiles of BQ query rows and 64 keys: BQ = 64 for
// heads up to 128 wide, 32 for wider heads, so that the fp32 tiles fit in
// the 227 KB a block may use (at d = d_v = 256: 222 KB). The dq kernel
// stages Q^T and dO^T once and walks K^T/V^T tiles; the dk/dv kernel stages
// K^T and V^T once and walks Q^T/dO^T tiles, writing P (then dS) into one
// shared tile that the dV (then dK) product reads.
//
// On an H100 (700 W) the bf16 pair takes 0.116-0.119 ms at BERT-base masked
// (26% of its byte bound; SDPA's backward 0.091), 0.54 ms at T=4096 causal
// (12% of its operation bound; SDPA 0.22) and 1.71-1.75 ms at T=16384 causal
// (5%; SDPA 0.38). What still holds it back: mma.sync, a fraction of the rate
// wgmma reaches; no TMA (every thread issues its own copies); S and dP are
// formed twice (once per kernel); at BERT-base each block's life is two
// tiles, so its first loads' latency is not hidden; at long causal T with
// few heads, the block that walks the most tiles (T / 64 of them, one 4-warp
// block alone on its SM at the end) sets the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;   // keys per tile
constexpr int kPad = 4;   // row padding of the transposed tiles (keeps 16 B alignment)
constexpr int kKS = kBK + kPad;
constexpr int kRK = kBK / 16;  // keys per thread in the score tile (4)
constexpr int kMaxDim = 256;

// query rows per tile: 64, or 32 at heads wider than 128
template <int DMAX> struct QTile { static constexpr int BQ = DMAX > 128 ? 32 : 64; };

struct Args {
  const void* q;       // (B, H, Tq, D)
  const void* k;       // (B, H, Tk, D)
  const void* v;       // (B, H, Tk, Dv)
  const void* o;       // (B, H, Tq, Dv)
  const void* dout;    // (B, H, Tq, Dv)
  const float* lse;    // (B, H, Tq) contiguous
  const float* bias;   // (B, Tk) or null
  float* delta;        // (B, H, Tq) contiguous: written by dq, read by dk/dv
  void* dq;            // (B, H, Tq, D)
  void* dk;            // (B, H, Tk, D)
  void* dv;            // (B, H, Tk, Dv)
  int B, H, Tq, Tk, D, Dv;
  // batch, head, time strides in elements of q, k, v, o, dout, dq, dk, dv
  long long s[8][3];
  float scale;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA cast
}

// x rounded to T and widened back: the value a T operand of a product holds
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// R consecutive floats from 16-byte (R = 4) or 8-byte (R = 2) aligned shared memory
template <int R> __device__ __forceinline__ void lds(const float* p, float (&out)[R]);
template <> __device__ __forceinline__ void lds<4>(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <> __device__ __forceinline__ void lds<2>(const float* p, float (&out)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  out[0] = v.x; out[1] = v.y;
}
template <int R> __device__ __forceinline__ void sts(float* p, const float (&in)[R]);
template <> __device__ __forceinline__ void sts<4>(float* p, const float (&in)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
template <> __device__ __forceinline__ void sts<2>(float* p, const float (&in)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
}

// rows [r0, r0 + n) of a (time, width) operand into a transposed fp32 tile
// (width, ld), zero past `valid` rows
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, int ld, const T* src, long long st, int r0,
                                        int n, int valid, int width) {
  for (int idx = threadIdx.x; idx < n * width; idx += kThreads) {
    const int r = idx / width, c = idx % width;
    dst[c * ld + r] = r < valid ? to_f(src[(long long)(r0 + r) * st + c]) : 0.0f;
  }
}

// S = Q K^T and dP = dO V^T for a tile: rows ty*RQ + i, keys tx*4 + j, from
// the transposed tiles qt (D, QS), dot (Dv, QS), kt (D, kKS), vt (Dv, kKS)
template <int RQ, int QS>
__device__ __forceinline__ void score_tiles(const float* qt, const float* dot, const float* kt,
                                            const float* vt, int D, int Dv, int tx, int ty,
                                            float (&s)[RQ][kRK], float (&dp)[RQ][kRK]) {
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < kRK; ++j) s[i][j] = dp[i][j] = 0.0f;
  for (int c = 0; c < D; ++c) {
    float qa[RQ], ka[kRK];
    lds<RQ>(qt + c * QS + ty * RQ, qa);
    lds<kRK>(kt + c * kKS + tx * kRK, ka);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < kRK; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
  }
  for (int c = 0; c < Dv; ++c) {
    float da[RQ], va[kRK];
    lds<RQ>(dot + c * QS + ty * RQ, da);
    lds<kRK>(vt + c * kKS + tx * kRK, va);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < kRK; ++j) dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
  }
}

// P = exp(S * scale + bias - lse) of one score, 0 where the key is excluded
template <bool CAUSAL>
__device__ __forceinline__ float prob(float s, const Args& a, const float* bias, int row, int key,
                                      float lse) {
  if (row >= a.Tq || key >= a.Tk || (CAUSAL && key > row)) return 0.0f;
  float x = s * a.scale;
  if (bias) x += bias[key];
  return expf(x - lse);
}

template <typename T, int DMAX, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int BQ = QTile<DMAX>::BQ, RQ = BQ / 16, QS = BQ + kPad, M = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, Dv = a.Dv;
  float* qt = smem;              // (D, QS) Q tile, transposed
  float* dot = qt + D * QS;      // (Dv, QS) dO tile, transposed
  float* kt = dot + Dv * QS;     // (D, kKS) K tile, transposed
  float* vt = kt + D * kKS;      // (Dv, kKS) V tile, transposed
  float* dst = vt + Dv * kKS;    // (kBK, QS) dS tile, transposed, rounded to T

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(a.q) + bi * a.s[kQ][0] + hi * a.s[kQ][1];
  const T* k = static_cast<const T*>(a.k) + bi * a.s[kK][0] + hi * a.s[kK][1];
  const T* v = static_cast<const T*>(a.v) + bi * a.s[kV][0] + hi * a.s[kV][1];
  const T* o = static_cast<const T*>(a.o) + bi * a.s[kO][0] + hi * a.s[kO][1];
  const T* dout = static_cast<const T*>(a.dout) + bi * a.s[kDO][0] + hi * a.s[kDO][1];
  T* dq = static_cast<T*>(a.dq) + bi * a.s[kDQ][0] + hi * a.s[kDQ][1];
  const float* bias = a.bias ? a.bias + (size_t)bi * a.Tk : nullptr;
  const int nq = min(BQ, a.Tq - q0);

  stage_t(qt, QS, q, a.s[kQ][2], q0, BQ, nq, D);
  stage_t(dot, QS, dout, a.s[kDO][2], q0, BQ, nq, Dv);
  __syncthreads();

  // delta = rowsum(dO * O) and lse of this thread's rows; the 16 threads of
  // a row group (one half warp) split the columns and reduce by shuffles
  float lse[RQ], delta[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i, row = q0 + r;
    float part = 0.0f;
    if (row < a.Tq)
      for (int c = tx; c < Dv; c += 16)
        part = fmaf(dot[c * QS + r], to_f(o[(long long)row * a.s[kO][2] + c]), part);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    delta[i] = part;
    lse[i] = row < a.Tq ? a.lse[(size_t)bh * a.Tq + row] : 0.0f;
    if (tx == 0 && row < a.Tq) a.delta[(size_t)bh * a.Tq + row] = part;
  }

  float acc[RQ][M];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[i][m] = 0.0f;

  int n_tiles = (a.Tk + kBK - 1) / kBK;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + nq + kBK - 1) / kBK);

  for (int kti = 0; kti < n_tiles; ++kti) {
    const int k0 = kti * kBK;
    const int nk = min(kBK, a.Tk - k0);
    __syncthreads();  // the previous tile's readers of kt, vt and dst are done
    stage_t(kt, kKS, k, a.s[kK][2], k0, kBK, nk, D);
    stage_t(vt, kKS, v, a.s[kV][2], k0, kBK, nk, Dv);
    __syncthreads();

    float s[RQ][kRK], dp[RQ][kRK];
    score_tiles<RQ, QS>(qt, dot, kt, vt, D, Dv, tx, ty, s, dp);
#pragma unroll
    for (int j = 0; j < kRK; ++j) {
      float ds[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = prob<CAUSAL>(s[i][j], a, bias, q0 + ty * RQ + i, k0 + tx * kRK + j,
                                     lse[i]);
        ds[i] = round_to<T>(p * (dp[i][j] - delta[i]) * a.scale);
      }
      sts<RQ>(dst + (tx * kRK + j) * QS + ty * RQ, ds);
    }
    __syncthreads();

    // dq += dS K: rows ty*RQ + i, columns tx + 16 m
    for (int kk = 0; kk < nk; ++kk) {
      float dsv[RQ];
      lds<RQ>(dst + kk * QS + ty * RQ, dsv);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int c = tx + 16 * m;
        if (c < D) {
          const float kv = kt[c * kKS + kk];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][m] = fmaf(dsv[i], kv, acc[i][m]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= a.Tq) continue;
    T* dqrow = dq + (long long)row * a.s[kDQ][2];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = tx + 16 * m;
      if (c < D) dqrow[c] = from_f<T>(acc[i][m]);
    }
  }
}

template <typename T, int DMAX, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int BQ = QTile<DMAX>::BQ, RQ = BQ / 16, QS = BQ + kPad, M = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, Dv = a.Dv;
  float* qt = smem;              // (D, QS) Q tile, transposed
  float* dot = qt + D * QS;      // (Dv, QS) dO tile, transposed
  float* kt = dot + Dv * QS;     // (D, kKS) K tile, transposed
  float* vt = kt + D * kKS;      // (Dv, kKS) V tile, transposed
  float* ps = vt + Dv * kKS;     // (BQ, kKS) P, then dS, rounded to T

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int k0 = blockIdx.x * kBK;
  const T* q = static_cast<const T*>(a.q) + bi * a.s[kQ][0] + hi * a.s[kQ][1];
  const T* k = static_cast<const T*>(a.k) + bi * a.s[kK][0] + hi * a.s[kK][1];
  const T* v = static_cast<const T*>(a.v) + bi * a.s[kV][0] + hi * a.s[kV][1];
  const T* dout = static_cast<const T*>(a.dout) + bi * a.s[kDO][0] + hi * a.s[kDO][1];
  T* dk = static_cast<T*>(a.dk) + bi * a.s[kDK][0] + hi * a.s[kDK][1];
  T* dv = static_cast<T*>(a.dv) + bi * a.s[kDV][0] + hi * a.s[kDV][1];
  const float* bias = a.bias ? a.bias + (size_t)bi * a.Tk : nullptr;
  const float* lse_bh = a.lse + (size_t)bh * a.Tq;
  const float* delta_bh = a.delta + (size_t)bh * a.Tq;
  const int nk = min(kBK, a.Tk - k0);

  stage_t(kt, kKS, k, a.s[kK][2], k0, kBK, nk, D);
  stage_t(vt, kKS, v, a.s[kV][2], k0, kBK, nk, Dv);

  // accumulators: keys ty*4 + i, columns tx + 16 m
  float adk[kRK][M], adv[kRK][M];
#pragma unroll
  for (int i = 0; i < kRK; ++i)
#pragma unroll
    for (int m = 0; m < M; ++m) adk[i][m] = adv[i][m] = 0.0f;

  const int n_tiles = (a.Tq + BQ - 1) / BQ;
  // under causal masking, query tiles wholly above the diagonal add nothing
  const int first = CAUSAL ? k0 / BQ : 0;
  for (int qti = first; qti < n_tiles; ++qti) {
    const int r0 = qti * BQ;
    const int nr = min(BQ, a.Tq - r0);
    __syncthreads();  // the previous tile's readers of qt, dot and ps are done
    stage_t(qt, QS, q, a.s[kQ][2], r0, BQ, nr, D);
    stage_t(dot, QS, dout, a.s[kDO][2], r0, BQ, nr, Dv);
    __syncthreads();

    float s[RQ][kRK], dp[RQ][kRK];
    score_tiles<RQ, QS>(qt, dot, kt, vt, D, Dv, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = r0 + ty * RQ + i;
      const float lse = row < a.Tq ? lse_bh[row] : 0.0f;
      const float delta = row < a.Tq ? delta_bh[row] : 0.0f;
#pragma unroll
      for (int j = 0; j < kRK; ++j) {
        const float p = prob<CAUSAL>(s[i][j], a, bias, row, k0 + tx * kRK + j, lse);
        dp[i][j] = round_to<T>(p * (dp[i][j] - delta) * a.scale);  // dS
        s[i][j] = round_to<T>(p);
      }
      sts<kRK>(ps + (ty * RQ + i) * kKS + tx * kRK, s[i]);
    }
    __syncthreads();

    // dv += P^T dO: keys ty*4 + i, columns tx + 16 m
    for (int rr = 0; rr < nr; ++rr) {
      float pv[kRK];
      lds<kRK>(ps + rr * kKS + ty * kRK, pv);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int c = tx + 16 * m;
        if (c < Dv) {
          const float dov = dot[c * QS + rr];
#pragma unroll
          for (int i = 0; i < kRK; ++i) adv[i][m] = fmaf(pv[i], dov, adv[i][m]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i) sts<kRK>(ps + (ty * RQ + i) * kKS + tx * kRK, dp[i]);
    __syncthreads();

    // dk += dS^T Q
    for (int rr = 0; rr < nr; ++rr) {
      float dsv[kRK];
      lds<kRK>(ps + rr * kKS + ty * kRK, dsv);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int c = tx + 16 * m;
        if (c < D) {
          const float qv = qt[c * QS + rr];
#pragma unroll
          for (int i = 0; i < kRK; ++i) adk[i][m] = fmaf(dsv[i], qv, adk[i][m]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRK; ++i) {
    const int key = k0 + ty * kRK + i;
    if (key >= a.Tk) continue;
    T* dkrow = dk + (long long)key * a.s[kDK][2];
    T* dvrow = dv + (long long)key * a.s[kDV][2];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = tx + 16 * m;
      if (c < D) dkrow[c] = from_f<T>(adk[i][m]);
      if (c < Dv) dvrow[c] = from_f<T>(adv[i][m]);
    }
  }
}

// ---------------------------------------------------------------- bf16 on the tensor cores
constexpr int kMmaMaxDim = 128;  // widest d or d_v of the tensor-core kernels
constexpr int kMmaBK = 64;       // keys per K/V tile (dq) and per block (dk/dv)

// Per head width (d and d_v up to DMAX): the query rows of a Q/dO tile of the
// dk/dv kernel, 64, or 32 at heads wider than 64 so that the score tiles and
// the dK, dV accumulators fit in registers; and the stages of both kernels'
// rings, 3 (the next two tiles in flight while one is multiplied), or 2 at
// heads wider than 64 so that the dq kernel's tiles leave room for two
// blocks on an SM.
template <int DMAX> struct MmaTiles {
  static constexpr int BQ = DMAX > 64 ? 32 : 64;
  static constexpr int STAGES = DMAX > 64 ? 2 : 3;
};

template <int DMAX, bool CAUSAL, bool VEC>
__global__ void __launch_bounds__(attn_mma::kMmaThreads) flash_bwd_dq_kernel_mma(Args a) {
  using namespace attn_mma;
  constexpr int BQ = kMmaRows, BK = kMmaBK, ST = MmaTiles<DMAX>::STAGES;
  constexpr int NT = BK / 8;    // score fragments (8 keys each) of a warp
  constexpr int NV = DMAX / 8;  // dQ fragments (8 columns each)
  static_assert(BQ == BK, "O is staged in the last V stage");
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int dp = round16(a.D), dvp = round16(a.Dv);
  const int qld = tile_ld(dp), vld = tile_ld(dvp);
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // (BQ, qld)
  bf16* dos = qs + BQ * qld;                      // (BQ, vld)
  bf16* ks = dos + BQ * vld;                      // ST x (BK, qld)
  bf16* vs = ks + ST * BK * qld;                  // ST x (BK, vld); the last stage holds O first

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, bi = bh / a.H, hi = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.s[kQ][0] + hi * a.s[kQ][1];
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.s[kK][0] + hi * a.s[kK][1];
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.s[kV][0] + hi * a.s[kV][1];
  const bf16* o = static_cast<const bf16*>(a.o) + bi * a.s[kO][0] + hi * a.s[kO][1];
  const bf16* dout = static_cast<const bf16*>(a.dout) + bi * a.s[kDO][0] + hi * a.s[kDO][1];
  const float* bias = a.bias ? a.bias + (size_t)bi * a.Tk : nullptr;

  int n_tiles = (a.Tk + BK - 1) / BK;
  if (CAUSAL) n_tiles = min(n_tiles, (min(q0 + BQ, a.Tq) + BK - 1) / BK);

  stage_tile<VEC>(qs, qld, q, a.s[kQ][2], q0, BQ, a.Tq, a.D, dp);
  stage_tile<VEC>(dos, vld, dout, a.s[kDO][2], q0, BQ, a.Tq, a.Dv, dvp);
  bf16* os = vs + (ST - 1) * BK * vld;  // O, until the ring first refills the last stage
  stage_tile<VEC>(os, vld, o, a.s[kO][2], q0, BQ, a.Tq, a.Dv, dvp);
  cp_async_commit();
  // K/V tile t into stage t, one commit group each (empty past the last tile)
  auto stage_keys = [&](int t, int st) {
    if (t < n_tiles) {
      stage_tile<VEC>(ks + st * BK * qld, qld, k, a.s[kK][2], t * BK, BK, a.Tk, a.D, dp);
      stage_tile<VEC>(vs + st * BK * vld, vld, v, a.s[kV][2], t * BK, BK, a.Tk, a.Dv, dvp);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) stage_keys(t, t);
  cp_async_wait<ST - 1>();  // Q, dO and O have landed
  __syncthreads();

  // delta = rowsum(dO * O) in fp32: two lanes a row (columns 8 apart in
  // steps of 16; the padding is zero), combined by one shuffle
  const int wrow = q0 + warp * 16;  // the warp's first row
  float part = 0.0f;
  {
    const int r = warp * 16 + (lane >> 1);
    const bf16* dor = dos + r * vld;
    const bf16* orow = os + r * vld;
    for (int c = (lane & 1) * 8; c < dvp; c += 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(dor + c);
      const uint4 y = *reinterpret_cast<const uint4*>(orow + c);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xp[e]), yf = __bfloat1622float2(yp[e]);
        part = fmaf(xf.x, yf.x, part);
        part = fmaf(xf.y, yf.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    const int row = q0 + r;
    if ((lane & 1) == 0 && row < a.Tq) a.delta[(size_t)bh * a.Tq + row] = part;
  }
  // this thread's rows g and g + 8 of the warp: delta from lanes 2g and 2g + 16
  const int g = lane >> 2, key_lane = 2 * (lane & 3), row0 = wrow + g;
  const float delta[2] = {__shfl_sync(0xffffffffu, part, 2 * g),
                          __shfl_sync(0xffffffffu, part, 2 * g + 16)};
  float lse[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lse[h] = row0 + 8 * h < a.Tq ? a.lse[(size_t)bh * a.Tq + row0 + 8 * h] : 0.0f;
  __syncthreads();  // every warp has read O before the ring refills its stage

  float acc[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nv][e] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % ST;
    stage_keys(j + ST - 1, (j + ST - 1) % ST);  // into the stage read last iteration
    cp_async_wait<ST - 1>();                    // this tile has landed
    __syncthreads();

    const int k0 = j * BK;
    const bf16* kt = ks + st * BK * qld;
    float bv[NT][2];
    if (bias) load_bias<NT>(bv, bias, k0, a.Tk);
    float s[NT][4], dpv[NT][4];
    warp_scores<NT, DMAX>(s, qs + warp * 16 * qld, qld, kt, qld, dp, NT / 2);
    warp_scores<NT, DMAX>(dpv, dos + warp * 16 * vld, vld, vs + st * BK * vld, vld, dvp, NT / 2);
    // keys past t_k, and causally excluded keys, only in an edge tile
    const bool edge = k0 + BK > a.Tk || (CAUSAL && k0 + BK - 1 > wrow);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // key c of the pair: entries c (row0) and c + 2 (row0 + 8)
        const int key = k0 + nt * 8 + key_lane + c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = c + 2 * h;
          float x = __fmul_rn(s[nt][e], a.scale);
          if (bias) x = __fadd_rn(x, bv[nt][c]);
          const bool out = edge && (key >= a.Tk || (CAUSAL && key > row0 + 8 * h));
          const float p = out ? 0.0f : exp_approx(__fsub_rn(x, lse[h]));
          s[nt][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dpv[nt][e], delta[h])), a.scale);  // dS
        }
      }
    uint32_t dsa[NT / 2][4];
    scores_to_a<NT>(dsa, s);  // dS rounded to bf16
    warp_pv<NT, NV>(acc, dsa, kt, qld, dp, NT / 2);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const float one[2] = {1.0f, 1.0f};
  bf16* dq = static_cast<bf16*>(a.dq) + bi * a.s[kDQ][0] + hi * a.s[kDQ][1];
  store_rows<NV, VEC>(dq, a.s[kDQ][2], wrow, a.Tq, a.D, acc, one);
}

template <int DMAX, bool CAUSAL, bool VEC>
__global__ void __launch_bounds__(attn_mma::kMmaThreads) flash_bwd_dkv_kernel_mma(Args a) {
  using namespace attn_mma;
  constexpr int BK = kMmaBK, BQ = MmaTiles<DMAX>::BQ, ST = MmaTiles<DMAX>::STAGES;
  constexpr int NT = BQ / 8;    // transposed score fragments (8 query columns each) of a warp
  constexpr int NV = DMAX / 8;  // dK, dV fragments (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int dp = round16(a.D), dvp = round16(a.Dv);
  const int qld = tile_ld(dp), vld = tile_ld(dvp);
  bf16* ks = reinterpret_cast<bf16*>(smem_mma);  // (BK, qld)
  bf16* vs = ks + BK * qld;                       // (BK, vld)
  bf16* qs = vs + BK * vld;                       // ST x (BQ, qld)
  bf16* dos = qs + ST * BQ * qld;                 // ST x (BQ, vld)
  float* rs = reinterpret_cast<float*>(dos + ST * BQ * vld);  // ST x (lse, delta) x BQ

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, bi = bh / a.H, hi = bh % a.H;
  const int k0 = blockIdx.y * BK;  // under causal masking the lowest keys work longest
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.s[kQ][0] + hi * a.s[kQ][1];
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.s[kK][0] + hi * a.s[kK][1];
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.s[kV][0] + hi * a.s[kV][1];
  const bf16* dout = static_cast<const bf16*>(a.dout) + bi * a.s[kDO][0] + hi * a.s[kDO][1];
  const float* lse_bh = a.lse + (size_t)bh * a.Tq;
  const float* delta_bh = a.delta + (size_t)bh * a.Tq;
  const int n_tiles = (a.Tq + BQ - 1) / BQ;
  // under causal masking, query tiles wholly above the diagonal add nothing
  const int first = CAUSAL ? k0 / BQ : 0;

  // query tile `tile` (Q, dO, and its rows' lse and delta) into stage st, one
  // commit group each (empty past the last tile)
  auto stage_queries = [&](int tile, int st) {
    if (tile < n_tiles) {
      const int r0 = tile * BQ;
      stage_tile<VEC>(qs + st * BQ * qld, qld, q, a.s[kQ][2], r0, BQ, a.Tq, a.D, dp);
      stage_tile<VEC>(dos + st * BQ * vld, vld, dout, a.s[kDO][2], r0, BQ, a.Tq, a.Dv, dvp);
      if (threadIdx.x < 2 * BQ) {
        const int which = threadIdx.x / BQ, i = threadIdx.x % BQ, row = r0 + i;
        const float* src = which ? delta_bh : lse_bh;
        cp_async4(rs + (2 * st + which) * BQ + i, row < a.Tq ? src + row : src,
                  row < a.Tq ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  stage_tile<VEC>(ks, qld, k, a.s[kK][2], k0, BK, a.Tk, a.D, dp);
  stage_tile<VEC>(vs, vld, v, a.s[kV][2], k0, BK, a.Tk, a.Dv, dvp);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) stage_queries(first + t, t);

  // this thread's keys: rows g and g + 8 of the warp's 16; their bias
  const int g = lane >> 2, col_lane = 2 * (lane & 3);
  const int kw = k0 + warp * 16, key0 = kw + g;
  float kb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    kb[h] = a.bias && key0 + 8 * h < a.Tk ? a.bias[(size_t)bi * a.Tk + key0 + 8 * h] : 0.0f;

  float adk[NV][4], adv[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nv][e] = adv[nv][e] = 0.0f;

  for (int i = first; i < n_tiles; ++i) {
    const int st = (i - first) % ST;
    stage_queries(i + ST - 1, (i - first + ST - 1) % ST);  // into the stage read last iteration
    cp_async_wait<ST - 1>();                               // this tile has landed
    __syncthreads();

    const int r0 = i * BQ;
    const bf16* qt = qs + st * BQ * qld;
    const bf16* dot = dos + st * BQ * vld;
    const float* lse_s = rs + 2 * st * BQ;
    const float* delta_s = lse_s + BQ;
    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns queries
    float s[NT][4], dpv[NT][4];
    warp_scores<NT, DMAX>(s, ks + warp * 16 * qld, qld, qt, qld, dp, NT / 2);
    warp_scores<NT, DMAX>(dpv, vs + warp * 16 * vld, vld, dot, vld, dvp, NT / 2);
    // queries past t_q, keys past t_k, and causally excluded pairs, only in an edge tile
    const bool edge = r0 + BQ > a.Tq || kw + 16 > a.Tk || (CAUSAL && r0 < kw + 15);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // lse and delta of the query columns col_lane, col_lane + 1 of this fragment
      const float2 lv = *reinterpret_cast<const float2*>(lse_s + nt * 8 + col_lane);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + nt * 8 + col_lane);
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // query c of the pair: entries c (key0) and c + 2 (key0 + 8)
        const int row = r0 + nt * 8 + col_lane + c;
        const float l = c ? lv.y : lv.x, d = c ? dl.y : dl.x;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = c + 2 * h, key = key0 + 8 * h;
          float x = __fmul_rn(s[nt][e], a.scale);
          if (a.bias) x = __fadd_rn(x, kb[h]);
          const bool out = edge && (row >= a.Tq || key >= a.Tk || (CAUSAL && key > row));
          const float p = out ? 0.0f : exp_approx(__fsub_rn(x, l));
          dpv[nt][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dpv[nt][e], d)), a.scale);  // dS^T
          s[nt][e] = p;
        }
      }
    }
    uint32_t pa[NT / 2][4], dsa[NT / 2][4];
    scores_to_a<NT>(pa, s);     // P^T rounded to bf16
    scores_to_a<NT>(dsa, dpv);  // dS^T rounded to bf16
    warp_pv<NT, NV>(adv, pa, dot, vld, dvp, NT / 2);
    warp_pv<NT, NV>(adk, dsa, qt, qld, dp, NT / 2);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const float one[2] = {1.0f, 1.0f};
  bf16* dk = static_cast<bf16*>(a.dk) + bi * a.s[kDK][0] + hi * a.s[kDK][1];
  bf16* dv = static_cast<bf16*>(a.dv) + bi * a.s[kDV][0] + hi * a.s[kDV][1];
  store_rows<NV, VEC>(dk, a.s[kDK][2], kw, a.Tk, a.D, adk, one);
  store_rows<NV, VEC>(dv, a.s[kDV][2], kw, a.Tk, a.Dv, adv, one);
}

// ---------------------------------------------------------------- launch
// Shared memory of either CUDA-core kernel (the same tiles, the last one BQ or kBK rows)
template <int DMAX>
size_t smem_bytes(const Args& a, bool dq) {
  constexpr int BQ = QTile<DMAX>::BQ, QS = BQ + kPad;
  const size_t last = dq ? (size_t)kBK * QS : (size_t)BQ * kKS;
  return sizeof(float) * ((size_t)(a.D + a.Dv) * QS + (size_t)(a.D + a.Dv) * kKS + last);
}

template <typename T, int DMAX, bool CAUSAL>
cudaError_t launch(const Args& a, bool dq, cudaStream_t stream) {
  constexpr int BQ = QTile<DMAX>::BQ;
  const size_t smem = smem_bytes<DMAX>(a, dq);
  auto kernel = dq ? flash_bwd_dq_kernel<T, DMAX, CAUSAL> : flash_bwd_dkv_kernel<T, DMAX, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(dq ? (a.Tq + BQ - 1) / BQ : (a.Tk + kBK - 1) / kBK, a.B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t dispatch_causal(const Args& a, bool causal, bool dq, cudaStream_t s) {
  return causal ? launch<T, DMAX, true>(a, dq, s) : launch<T, DMAX, false>(a, dq, s);
}

template <int DMAX, bool CAUSAL, bool VEC>
cudaError_t launch_mma(const Args& a, bool dq, cudaStream_t stream) {
  using namespace attn_mma;
  constexpr int BQ = MmaTiles<DMAX>::BQ, ST = MmaTiles<DMAX>::STAGES;
  const size_t qld = tile_ld(round16(a.D)), vld = tile_ld(round16(a.Dv));
  // dq: Q, dO and ST K/V stages; dk/dv: K, V and ST stages of Q, dO, lse, delta
  const size_t smem = dq ? sizeof(bf16) * (kMmaRows + ST * kMmaBK) * (qld + vld)
                         : sizeof(bf16) * (kMmaBK + ST * BQ) * (qld + vld) +
                               sizeof(float) * ST * 2 * BQ;
  auto kernel = dq ? flash_bwd_dq_kernel_mma<DMAX, CAUSAL, VEC>
                   : flash_bwd_dkv_kernel_mma<DMAX, CAUSAL, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = dq ? a.Tq : a.Tk;  // 64-row tiles of queries (dq) or keys (dk/dv)
  const dim3 grid(a.B * a.H, (rows + kMmaRows - 1) / kMmaRows);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t dispatch_mma(const Args& a, bool causal, bool vec, bool dq, cudaStream_t s) {
  if (causal)
    return vec ? launch_mma<DMAX, true, true>(a, dq, s) : launch_mma<DMAX, true, false>(a, dq, s);
  return vec ? launch_mma<DMAX, false, true>(a, dq, s) : launch_mma<DMAX, false, false>(a, dq, s);
}

// By width alone: float32 on the CUDA cores; bf16 on the tensor cores up to
// kMmaMaxDim, on the CUDA cores beyond.
cudaError_t dispatch(const Args& a, bool bf16, bool causal, bool vec, bool dq, cudaStream_t s) {
  const int widest = a.D > a.Dv ? a.D : a.Dv;
  if (!bf16) {
    if (widest <= 64) return dispatch_causal<float, 64>(a, causal, dq, s);
    if (widest <= 128) return dispatch_causal<float, 128>(a, causal, dq, s);
    return dispatch_causal<float, 256>(a, causal, dq, s);
  }
  if (widest <= 64) return dispatch_mma<64>(a, causal, vec, dq, s);
  if (widest <= kMmaMaxDim) return dispatch_mma<kMmaMaxDim>(a, causal, vec, dq, s);
  return dispatch_causal<__nv_bfloat16, 256>(a, causal, dq, s);
}

int run(bool dq, int dtype, const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, const float* bias, float* delta, void* dqp, void* dkp,
        void* dvp, int B, int H, int Tq, int Tk, int D, int Dv, const long long* strides,
        float scale, int causal, int vec, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || Dv < 1 || D > kMaxDim || Dv > kMaxDim ||
      (long long)B * H > 65535 || (causal && Tq != Tk) || strides == nullptr ||
      (Tq + 63) / 64 > 65535 || (Tk + 63) / 64 > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, lse, bias, delta, dqp, dkp, dvp, B, H, Tq, Tk, D, Dv, {}, scale};
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) a.s[t][j] = strides[t * 3 + j];
  const bool bf16 = dtype == 1;
  if (bf16 && vec) {  // the launcher's claim, re-checked: a misaligned cp.async loses the context
    const void* ptrs[8] = {q, k, v, o, dout, dqp, dkp, dvp};
    const int times[8] = {Tq, Tk, Tk, Tq, Tq, Tq, Tk, Tk};
    const int widths[8] = {D, D, Dv, Dv, Dv, D, D, Dv};
    for (int t = 0; t < 8; ++t)
      if (ptrs[t] && !attn_mma::rows_vectorizable(ptrs[t], a.s[t], B, H, times[t], widths[t]))
        return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch(a, bf16, causal != 0, vec != 0, dq, static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are (B, H, Tq) fp32
// contiguous; bias (B, Tk) fp32 may be null. strides holds 24 values: the
// (batch, head, time) strides in elements of q, k, v, o, dout, dq, dk and dv,
// in that order; the last dimension of each must be contiguous. causal needs
// Tq == Tk. vec: the bf16 tensor-core kernels stage with 16-byte cp.async
// copies, which needs every row of the operands the call gets to start on a
// 16-byte boundary with d and d_v multiples of 8 (refused otherwise); 0
// stages element by element. The CUDA-core kernels stage element by element
// either way. dl4j_flash_bwd_dq writes dq and delta; dl4j_flash_bwd_dkv
// reads that delta and writes dk and dv, so it is launched after it on the
// same stream. Each returns the cudaError_t of its launch (0 on success).
extern "C" int dl4j_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, const float* lse,
                                 const float* bias, float* delta, void* dq, int B, int H, int Tq,
                                 int Tk, int D, int Dv, const long long* strides, float scale,
                                 int causal, int vec, void* stream) {
  return run(true, dtype, q, k, v, o, dout, lse, bias, delta, dq, nullptr, nullptr, B, H, Tq, Tk,
             D, Dv, strides, scale, causal, vec, stream);
}

extern "C" int dl4j_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* bias,
                                  const float* delta, void* dk, void* dv, int B, int H, int Tq,
                                  int Tk, int D, int Dv, const long long* strides, float scale,
                                  int causal, int vec, void* stream) {
  return run(false, dtype, q, k, v, nullptr, dout, lse, bias, const_cast<float*>(delta), nullptr,
             dk, dv, B, H, Tq, Tk, D, Dv, strides, scale, causal, vec, stream);
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
