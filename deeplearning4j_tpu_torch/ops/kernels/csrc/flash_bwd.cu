// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package's
// deeplearning4j_tpu/ops/pallas/flash_attention.py, _flash_bwd (dq
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
// stored in T. Launch the dq kernel first: the dk/dv kernel reads its delta.
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
// Bound at the BERT-base training shape (B=64, h=12, T=128, d=64, bf16): it
// reads q, k, v, o, dO and writes dq, dk, dv, 8 x 12.6 MB = 101 MB, 30 us at
// 3.35 TB/s, against 4 products of 2 x 768 x 128^2 x 64 FLOP = 6.4 GFLOP,
// 6.5 us at 989 TFLOP/s: bytes.
//
// Design (first version: right and simple, like the forward): 256 threads,
// CUDA-core products in fp32 from shared memory. Tiles of BQ query rows and
// 64 keys: BQ = 64 for heads up to 128 wide, 32 for wider heads, so that the
// fp32 tiles fit in the 227 KB a block may use (at d = d_v = 256: 222 KB).
// Both kernels recompute S and dP tile by tile: the dq kernel stages Q^T and
// dO^T once and walks K^T/V^T tiles; the dk/dv kernel stages K^T and V^T once
// and walks Q^T/dO^T tiles, writing P (then dS) into one shared tile that the
// dV (then dK) product reads. Each thread owns a (BQ/16) x 4 block of the
// score tile and, for the accumulators, 4 (dk/dv) or BQ/16 (dq) rows by the
// columns tx + 16 m. Tensor cores (mma/wgmma), TMA and pipelining are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// Shared memory of either kernel (the same tiles, the last one BQ or kBK rows)
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

template <typename T>
cudaError_t dispatch(const Args& a, bool causal, bool dq, cudaStream_t s) {
  const int widest = a.D > a.Dv ? a.D : a.Dv;
  if (widest <= 64) return dispatch_causal<T, 64>(a, causal, dq, s);
  if (widest <= 128) return dispatch_causal<T, 128>(a, causal, dq, s);
  return dispatch_causal<T, 256>(a, causal, dq, s);
}

int run(bool dq, int dtype, const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, const float* bias, float* delta, void* dqp, void* dkp,
        void* dvp, int B, int H, int Tq, int Tk, int D, int Dv, const long long* strides,
        float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || Dv < 1 || D > kMaxDim || Dv > kMaxDim ||
      (long long)B * H > 65535 || (causal && Tq != Tk) || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, lse, bias, delta, dqp, dkp, dvp, B, H, Tq, Tk, D, Dv, {}, scale};
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) a.s[t][j] = strides[t * 3 + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, causal != 0, dq, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, causal != 0, dq, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are (B, H, Tq) fp32
// contiguous; bias (B, Tk) fp32 may be null. strides holds 24 values: the
// (batch, head, time) strides in elements of q, k, v, o, dout, dq, dk and dv,
// in that order; the last dimension of each must be contiguous. causal needs
// Tq == Tk. dl4j_flash_bwd_dq writes dq and delta; dl4j_flash_bwd_dkv reads
// that delta and writes dk and dv, so it is launched after it on the same
// stream. Each returns the cudaError_t of its launch (0 on success).
extern "C" int dl4j_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, const float* lse,
                                 const float* bias, float* delta, void* dq, int B, int H, int Tq,
                                 int Tk, int D, int Dv, const long long* strides, float scale,
                                 int causal, void* stream) {
  return run(true, dtype, q, k, v, o, dout, lse, bias, delta, dq, nullptr, nullptr, B, H, Tq, Tk,
             D, Dv, strides, scale, causal, stream);
}

extern "C" int dl4j_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* bias,
                                  const float* delta, void* dk, void* dv, int B, int H, int Tq,
                                  int Tk, int D, int Dv, const long long* strides, float scale,
                                  int causal, void* stream) {
  return run(false, dtype, q, k, v, nullptr, dout, lse, bias, const_cast<float*>(delta), nullptr,
             dk, dv, B, H, Tq, Tk, D, Dv, strides, scale, causal, stream);
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
