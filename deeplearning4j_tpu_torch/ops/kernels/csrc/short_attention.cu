// Short-sequence attention (t <= 512), forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package's
// deeplearning4j_tpu/ops/pallas/fused_attention_short.py: _short_fwd
// (pallas_call at :169) and _short_bwd_vjp (:197) on (b, h, t, d), and
// _btd_fwd (:320) and _btd_bwd_vjp (:353) on (b, t, h*d). Both layouts are
// the same arithmetic: the kernels read q, k, v, dO and write o, dq, dk, dv
// through (batch, head, time) strides with a unit stride along d, so the
// (b, t, h*d) layout is the (b, t, h, d) view and costs no transpose.
//
// Semantics, as the Pallas kernels' (_fwd_kernel :67, _bwd_kernel :79):
//   - S = (Q . K) * scale in fp32 (products of T operands, fp32 sums), then
//     + bias, the fp32 key-padding bias (B, t) of 0 / -1e30. The two are
//     separate roundings (__fmul_rn, __fadd_rn). Masked keys are not
//     skipped, so a fully masked row gives P = 1/t, the mean of V;
//   - the softmax is exact over the whole row: m = max, e = exp(S - m),
//     l = sum e, P = e / l (no online rescaling);
//   - O = round_T(P) @ V, fp32 sums, stored in T;
//   - backward: dV = round_T(P)^T dO, dP = dO V^T in fp32,
//     delta = rowsum(dP * P), dS = round_T(P * (dP - delta) * scale),
//     dQ = dS K, dK = dS^T Q, each stored in T.
// t_q == t_k == t, 1 <= t <= 512; 1 <= d <= 256; T is float or bf16.
//
// Bound at BERT-base (b=64, h=12, t=128, d=64, bf16): the forward moves q,
// k, v, o, 4 x 12.6 MB = 50 MB, 15.0 us at 3.35 TB/s, against 4 t^2 d FLOP
// per head (3.2 GFLOP, 3.3 us at 989 TFLOP/s): bytes. The backward moves q,
// k, v, dO, dq, dk, dv, 88 MB, 26.3 us, against 10 t^2 d FLOP per head (8.1
// GFLOP, 8.2 us): bytes.
//
// Forward design, bf16 (short_fwd_mma_kernel): a block of 4 warps per
// (batch * head, 64-query tile), 16 query rows a warp, products on
// mma.sync m16n8k16 (bf16 operands, fp32 sums) with the tile machinery of
// attention_mma.cuh: operands staged as bf16 by cp.async (element by
// element where a row does not start on a 16-byte boundary; the launcher
// sets VEC from the pointers and strides), d padded to a multiple of 16
// with zeros, scores and P in registers. P is normalised before it is
// rounded, so no online rescaling of a rounded P:
//   - t <= 128 and d <= 128 (RESIDENT): K and V of the head are staged
//     whole, as two cp.async groups, so V lands while S = Q K^T runs; each
//     warp keeps its 16 rows' whole score rows in registers (64 fp32 values
//     a thread at t = 128), takes the exact max and sum across the quad,
//     forms round(e / l) straight into the A fragments of P V;
//   - otherwise (t up to 512, or d > 128) two passes over K/V tiles of 64
//     keys (32 at d > 128) in a ring of two stages: the first finds each
//     row's max m and sum l (l rescaled as m grows), the second recomputes
//     S, forms round(exp(S - m) / l) in registers and multiplies it by V.
// The exponentials and the division stay expf and __fdiv_rn, as in the
// float32 kernel (short_fwd_kernel, the card's check of the algorithm),
// which stays on the CUDA cores: a block per (32-query tile, batch * head)
// keeps its rows' score rows in shared memory as fp32 and forms each score
// with a scalar dot over staged rows.
// On an H100 (700 W) the bf16 forward takes 0.047-0.048 ms at BERT-base in
// either layout (32% of its byte bound; SDPA 0.021). What still holds it
// back: mma.sync rather than wgmma, each of a head's two query tiles
// reading all of its K and V, the exact expf and division per score, and
// each block's short life (one pass over the head) leaving its loads'
// latency exposed.
//
// Backward: two kernels, launched in this order on one stream under one
// launch count. dK and dV sum over every query and a block cannot keep a
// (t, d) fp32 sum for all of them, so (1) a dq kernel, a block per query
// tile, forms its rows' S and dP, the exact softmax, delta and dS, writes
// each row's m, l and delta (fp32 scratch of 3 x (B*H, t), made by the
// wrapper) and dQ = dS K; (2) a dk/dv kernel, a block per key tile, walks
// every query tile, recomputes S and dP for its keys, takes P and dS from
// the saved m, l and delta, and sums dV and dK in registers. Nothing of the
// forward is read: the autograd Function saves q, k, v and the mask only.
// No atomics, so a second launch gives the same bits.
//
// Backward design, bf16 with d <= 128 (short_bwd_dq_kernel_mma,
// short_bwd_dkv_kernel_mma), on attention_mma.cuh as the forward: blocks
// of 4 warps, 16 rows a warp, every product on mma.sync m16n8k16, operands
// staged as bf16 rows padded to a multiple of 16 columns (cp.async where
// VEC, element by element otherwise), P and dS in registers:
//   - dq: a block owns 64 query rows; Q and dO are staged once. RESIDENT (t
//     <= 128): K and V of the head whole, as two cp.async groups (Q and K,
//     then dO and V), so that V lands while S = Q K^T runs; each warp keeps
//     its rows' whole S and dP in registers, takes the exact m and l across
//     the quad, delta, dS straight into A fragments, and dQ += dS K with K
//     through ldmatrix.trans. Otherwise (t up to 512) three passes over K/V
//     tiles of 64 keys in a ring of two cp.async stages that runs on from
//     one pass into the next: S -> m and l (l rescaled as m grows); S and
//     dP -> delta; S and dP again -> dS -> dQ.
//   - dk/dv: a block owns 64 keys; K and V are staged once. Query tiles (64
//     rows, 32 at d > 64 so that the dK and dV accumulators fit) walk in a
//     ring of two stages of Q, dO and the rows' m, l and delta (4-byte
//     cp.async). S^T = K Q^T and dP^T = V dO^T (K and V as the A operand)
//     leave P^T (per column: exp(S^T - m) / l, the bias per row, loaded
//     once) and dS^T in registers as A fragments of dV += round(P^T) dO
//     and dK += dS^T Q: nothing goes through shared memory.
// One score, one arithmetic: both kernels form the S (and dP) of a (query,
// key) pair as one C entry of m16n8k16 products over the same 16-wide steps
// of the padded d, in the same order, from the same bf16 operands; the dq
// kernel as Q K^T (query row, key column), the dk/dv kernel as K Q^T (key
// row, query column). A product of two bf16 values is exact in fp32 and
// commutes, so each step's 16 products are the same values in both, and
// the tensor core adds them and the running C by their position along k,
// whatever the entry's row and column. Scale and bias are then the same
// two roundings, m, l and delta are the stored floats, and P = expf(x - m)
// / l (__fdiv_rn) and dS = round(P (dP - delta) scale) are the same bits
// in both kernels. expf, not exp_approx: the exact softmax of the plain
// version and the Pallas kernel, and a fully masked row keeps P = 1/t.
// Keys past t weigh exactly 0 in m, l, delta and dS.
// Dispatch by dtype and width alone: float32 (the card's check of the
// algorithm) and bf16 with d > 128 take the CUDA-core pair
// (short_bwd_dq_kernel, short_bwd_dkv_kernel: 256 threads, operands staged
// as fp32, scalar dots; a dq block per 16 query rows, a dk/dv block per 32
// keys walking query tiles of 16).
// On an H100 (700 W) the bf16 pair takes 0.142-0.145 ms at BERT-base in
// either layout (dq 0.068-0.070, dk/dv 0.074-0.075; 18% of its byte bound;
// SDPA's backward 0.086-0.093), from 1.34-1.54 ms for the CUDA-core pair,
// and 0.350-0.355 ms at (8, 12, 512, 64) (dq 0.233-0.236 in three passes;
// SDPA's backward 0.067-0.069). What still holds it back: mma.sync rather
// than wgmma; S and dP formed in both kernels (at t > 128, S four times and
// dP three); expf and an IEEE division per score in each kernel; blocks
// that live for one or two tiles, so their first loads' latency is not
// hidden.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFwdRows = 32;  // query rows per forward block
constexpr int kDqRows = 16;   // query rows per dq block, and per step of a dk/dv block
constexpr int kKvKeys = 32;   // keys per dk/dv block
constexpr int kTile = 64;     // keys (values) per staged tile of the forward and dq kernels
constexpr int kMaxSeq = 512;
constexpr int kMaxDim = 256;

struct Args {
  const void* q;      // (B, H, T, D) through qs
  const void* k;      // through ks
  const void* v;      // through vs
  const void* dout;   // backward: dO through dos
  const float* bias;  // (B, T) or null
  void* o;            // forward: O through os
  void* dq;           // backward outputs through dqs, dks, dvs
  void* dk;
  void* dv;
  float* m;           // backward scratch, (B*H, T) each: row max, row sum, delta
  float* l;
  float* delta;
  int B, H, T, D;
  long long qs[3], ks[3], vs[3], dos[3], os[3], dqs[3], dks[3], dvs[3];
  float scale;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA cast
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T>
__device__ __forceinline__ const T* head(const void* base, const long long* s, int bi, int hi) {
  return static_cast<const T*>(base) + bi * s[0] + hi * s[1];
}
template <typename T>
__device__ __forceinline__ T* head_out(void* base, const long long* s, int bi, int hi) {
  return static_cast<T*>(base) + bi * s[0] + hi * s[1];
}

// rows [r0, r0 + n) of a (T, D) head into dst (n rows of stride D + 1), fp32,
// zero past T
template <typename T>
__device__ void stage(float* dst, const T* src, long long st, int r0, int n, int T_, int D) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < T_ ? to_f(src[(long long)(r0 + r) * st + c]) : 0.0f;
  }
}

// fp32 dot product of two staged rows, summed in order of d
__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float acc = 0.0f;
  for (int c = 0; c < D; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// one score: (q . k) * scale, then + bias, two roundings
__device__ __forceinline__ float score(const float* q, const float* k, int D, float scale,
                                       const float* bias, int key) {
  const float s = __fmul_rn(dot(q, k, D), scale);
  return bias ? __fadd_rn(s, bias[key]) : s;
}

// P of one score from its row's max and sum
__device__ __forceinline__ float prob(float s, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(s, m)), l);
}

// dS of one entry before it is rounded: P (dP - delta) scale
__device__ __forceinline__ float dscore_f32(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// dS of one entry, rounded to T
template <typename T>
__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return round_to<T>(dscore_f32(p, dp, delta, scale));
}

size_t fwd_smem(int T_, int D) {
  return sizeof(float) * ((size_t)kFwdRows * (D + 1) + (size_t)kFwdRows * T_ +
                          (size_t)kTile * (D + 1));
}

size_t dq_smem(int T_, int D) {
  return sizeof(float) * (2 * (size_t)kDqRows * (D + 1) + 2 * (size_t)kDqRows * T_ +
                          (size_t)kTile * (D + 1));
}

size_t dkv_smem(int D) {
  return sizeof(float) * (2 * (size_t)kKvKeys * (D + 1) + 2 * (size_t)kDqRows * (D + 1) +
                          2 * (size_t)kDqRows * kKvKeys);
}

// float32 forward on the CUDA cores (bf16 runs short_fwd_mma_kernel). NJ:
// output columns per thread in steps of 16 (DMAX / 16, DMAX = 64, 128 or 256)
template <int NJ>
__global__ void __launch_bounds__(kThreads) short_fwd_kernel(Args a) {
  using T = float;
  extern __shared__ float smem[];
  const int D = a.D, DS = a.D + 1, T_ = a.T;
  float* qt = smem;                  // (kFwdRows, DS) Q rows
  float* st = qt + kFwdRows * DS;    // (kFwdRows, T) scores, then round(P)
  float* kv = st + kFwdRows * T_;    // (kTile, DS) a K or V tile
  const int tid = threadIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int q0 = blockIdx.x * kFwdRows;
  const T* q = head<T>(a.q, a.qs, bi, hi);
  const T* k = head<T>(a.k, a.ks, bi, hi);
  const T* v = head<T>(a.v, a.vs, bi, hi);
  const float* bias = a.bias ? a.bias + (size_t)bi * T_ : nullptr;

  stage(qt, q, a.qs[2], q0, kFwdRows, T_, D);
  for (int k0 = 0; k0 < T_; k0 += kTile) {
    const int nk = min(kTile, T_ - k0);
    __syncthreads();
    stage(kv, k, a.ks[2], k0, nk, T_, D);
    __syncthreads();
    for (int idx = tid; idx < kFwdRows * nk; idx += kThreads) {
      const int r = idx / nk, kk = idx % nk;
      st[r * T_ + k0 + kk] = score(qt + r * DS, kv + kk * DS, D, a.scale, bias, k0 + kk);
    }
  }
  __syncthreads();

  // exact softmax, 8 threads a row (the 8 share a warp)
  {
    const int r = tid / 8, lane = tid % 8;
    float* row = st + r * T_;
    float m = -INFINITY;
    for (int key = lane; key < T_; key += 8) m = fmaxf(m, row[key]);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.0f;
    for (int key = lane; key < T_; key += 8) l += expf(__fsub_rn(row[key], m));
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    __syncwarp();
    for (int key = lane; key < T_; key += 8) row[key] = round_to<T>(prob(row[key], m, l));
  }

  // O = round(P) V: rows ty*2 + i, columns tx + 16 j
  const int tx = tid % 16, ty = tid / 16;
  float acc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < T_; k0 += kTile) {
    const int nk = min(kTile, T_ - k0);
    __syncthreads();
    stage(kv, v, a.vs[2], k0, nk, T_, D);
    __syncthreads();
    for (int kk = 0; kk < nk; ++kk) {
      const float p0 = st[(ty * 2) * T_ + k0 + kk], p1 = st[(ty * 2 + 1) * T_ + k0 + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < D ? kv[kk * DS + c] : 0.0f;
        acc[0][j] = fmaf(p0, vv, acc[0][j]);
        acc[1][j] = fmaf(p1, vv, acc[1][j]);
      }
    }
  }
  T* o = head_out<T>(a.o, a.os, bi, hi);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty * 2 + i;
    if (row >= T_) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) o[(long long)row * a.os[2] + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) short_bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, DS = a.D + 1, T_ = a.T;
  float* qt = smem;                  // (kDqRows, DS) Q rows
  float* dot_ = qt + kDqRows * DS;   // (kDqRows, DS) dO rows
  float* st = dot_ + kDqRows * DS;   // (kDqRows, T) scores, then round(dS)
  float* dpt = st + kDqRows * T_;    // (kDqRows, T) dP
  float* kv = dpt + kDqRows * T_;    // (kTile, DS) a K or V tile
  const int tid = threadIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int q0 = blockIdx.x * kDqRows;
  const T* q = head<T>(a.q, a.qs, bi, hi);
  const T* k = head<T>(a.k, a.ks, bi, hi);
  const T* v = head<T>(a.v, a.vs, bi, hi);
  const T* dout = head<T>(a.dout, a.dos, bi, hi);
  const float* bias = a.bias ? a.bias + (size_t)bi * T_ : nullptr;

  stage(qt, q, a.qs[2], q0, kDqRows, T_, D);
  stage(dot_, dout, a.dos[2], q0, kDqRows, T_, D);
  for (int k0 = 0; k0 < T_; k0 += kTile) {
    const int nk = min(kTile, T_ - k0);
    __syncthreads();
    stage(kv, k, a.ks[2], k0, nk, T_, D);
    __syncthreads();
    for (int idx = tid; idx < kDqRows * nk; idx += kThreads) {
      const int r = idx / nk, kk = idx % nk;
      st[r * T_ + k0 + kk] = score(qt + r * DS, kv + kk * DS, D, a.scale, bias, k0 + kk);
    }
    __syncthreads();
    stage(kv, v, a.vs[2], k0, nk, T_, D);
    __syncthreads();
    for (int idx = tid; idx < kDqRows * nk; idx += kThreads) {
      const int r = idx / nk, kk = idx % nk;
      dpt[r * T_ + k0 + kk] = dot(dot_ + r * DS, kv + kk * DS, D);
    }
  }
  __syncthreads();

  // softmax, delta and dS, 16 threads a row (the 16 share a warp)
  {
    const int r = tid / 16, lane = tid % 16;
    float* row = st + r * T_;
    const float* dprow = dpt + r * T_;
    float m = -INFINITY;
    for (int key = lane; key < T_; key += 16) m = fmaxf(m, row[key]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.0f;
    for (int key = lane; key < T_; key += 16) l += expf(__fsub_rn(row[key], m));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    float delta = 0.0f;
    for (int key = lane; key < T_; key += 16)
      delta = __fadd_rn(delta, __fmul_rn(dprow[key], prob(row[key], m, l)));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, off);
    __syncwarp();
    for (int key = lane; key < T_; key += 16)
      row[key] = dscore<T>(prob(row[key], m, l), dprow[key], delta, a.scale);
    const int qrow = q0 + r;
    if (lane == 0 && qrow < T_) {
      const size_t at = (size_t)bh * T_ + qrow;
      a.m[at] = m;
      a.l[at] = l;
      a.delta[at] = delta;
    }
  }

  // dQ = dS K: row tid / 16, columns tx + 16 j
  const int tx = tid % 16, r = tid / 16;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < T_; k0 += kTile) {
    const int nk = min(kTile, T_ - k0);
    __syncthreads();
    stage(kv, k, a.ks[2], k0, nk, T_, D);
    __syncthreads();
    for (int kk = 0; kk < nk; ++kk) {
      const float ds = st[r * T_ + k0 + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        acc[j] = fmaf(ds, c < D ? kv[kk * DS + c] : 0.0f, acc[j]);
      }
    }
  }
  const int row = q0 + r;
  if (row < T_) {
    T* dq = head_out<T>(a.dq, a.dqs, bi, hi) + (long long)row * a.dqs[2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dq[c] = from_f<T>(acc[j]);
    }
  }
}

// NJ8: columns per thread in steps of 8 (DMAX / 8)
template <typename T, int NJ8>
__global__ void __launch_bounds__(kThreads) short_bwd_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, DS = a.D + 1, T_ = a.T;
  float* kt = smem;                      // (kKvKeys, DS) this block's K rows
  float* vt = kt + kKvKeys * DS;         // (kKvKeys, DS) V rows
  float* qt = vt + kKvKeys * DS;         // (kDqRows, DS) Q rows of one query tile
  float* dot_ = qt + kDqRows * DS;       // (kDqRows, DS) dO rows
  float* pt = dot_ + kDqRows * DS;       // (kDqRows, kKvKeys) round(P)
  float* dst = pt + kDqRows * kKvKeys;   // (kDqRows, kKvKeys) round(dS)
  const int tid = threadIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int k0 = blockIdx.x * kKvKeys;
  const T* q = head<T>(a.q, a.qs, bi, hi);
  const T* k = head<T>(a.k, a.ks, bi, hi);
  const T* v = head<T>(a.v, a.vs, bi, hi);
  const T* dout = head<T>(a.dout, a.dos, bi, hi);
  const float* bias = a.bias ? a.bias + (size_t)bi * T_ : nullptr;
  const float* mrow = a.m + (size_t)bh * T_;
  const float* lrow = a.l + (size_t)bh * T_;
  const float* drow = a.delta + (size_t)bh * T_;

  stage(kt, k, a.ks[2], k0, kKvKeys, T_, D);
  stage(vt, v, a.vs[2], k0, kKvKeys, T_, D);
  // dK, dV: key tid / 8, columns cx + 8 j
  const int cx = tid % 8, key = tid / 8;
  float dk[NJ8], dv[NJ8];
#pragma unroll
  for (int j = 0; j < NJ8; ++j) dk[j] = dv[j] = 0.0f;
  for (int q0 = 0; q0 < T_; q0 += kDqRows) {
    const int nq = min(kDqRows, T_ - q0);
    __syncthreads();
    stage(qt, q, a.qs[2], q0, nq, T_, D);
    stage(dot_, dout, a.dos[2], q0, nq, T_, D);
    __syncthreads();
    for (int idx = tid; idx < kDqRows * kKvKeys; idx += kThreads) {
      const int r = idx / kKvKeys, kk = idx % kKvKeys;
      float p = 0.0f, ds = 0.0f;
      if (r < nq && k0 + kk < T_) {
        const int qrow = q0 + r;
        p = prob(score(qt + r * DS, kt + kk * DS, D, a.scale, bias, k0 + kk), mrow[qrow],
                 lrow[qrow]);
        ds = dscore<T>(p, dot(dot_ + r * DS, vt + kk * DS, D), drow[qrow], a.scale);
      }
      pt[idx] = round_to<T>(p);
      dst[idx] = ds;
    }
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      const float p = pt[r * kKvKeys + key], ds = dst[r * kKvKeys + key];
#pragma unroll
      for (int j = 0; j < NJ8; ++j) {
        const int c = cx + 8 * j;
        if (c < D) {
          dv[j] = fmaf(p, dot_[r * DS + c], dv[j]);
          dk[j] = fmaf(ds, qt[r * DS + c], dk[j]);
        }
      }
    }
  }
  const int kr = k0 + key;
  if (kr < T_) {
    T* dko = head_out<T>(a.dk, a.dks, bi, hi) + (long long)kr * a.dks[2];
    T* dvo = head_out<T>(a.dv, a.dvs, bi, hi) + (long long)kr * a.dvs[2];
#pragma unroll
    for (int j = 0; j < NJ8; ++j) {
      const int c = cx + 8 * j;
      if (c < D) {
        dko[c] = from_f<T>(dk[j]);
        dvo[c] = from_f<T>(dv[j]);
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 tensor-core helpers
// S of the keys [k0, k0 + 8 NT) for one warp's 16 query rows at qw, from the
// key rows at kt (both of stride ld, dp columns): (q . k) * scale, then
// + bias, two roundings; keys past t at -inf (weight 0). Only the first
// `pairs` 16-key steps are multiplied.
template <int NT, int DMAX>
__device__ __forceinline__ void row_scores(float (&s)[NT][4], const attn_mma::bf16* qw,
                                           const attn_mma::bf16* kt, int ld, int dp, int pairs,
                                           int k0, int t, float scale, const float* bias) {
  using namespace attn_mma;
  float bv[NT][2];
  if (bias) load_bias<NT>(bv, bias, k0, t);
  warp_scores<NT, DMAX>(s, qw, ld, kt, ld, dp, pairs);
  const int key_lane = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + nt * 8 + key_lane + (e & 1);
      float x = -INFINITY;
      if (key < t) {
        x = __fmul_rn(s[nt][e], scale);
        if (bias) x = __fadd_rn(x, bv[nt][e & 1]);
      }
      s[nt][e] = x;
    }
}

// The exact softmax of a warp's 16 score rows held whole in s: m = max and
// l = sum exp(S - m) across the quad, then s = exp(S - m) / l.
template <int NT>
__device__ __forceinline__ void exact_softmax(float (&s)[NT][4], float (&m)[2], float (&l)[2]) {
  using namespace attn_mma;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
    m[h] = quad_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[nt][e] = expf(__fsub_rn(s[nt][e], m[h]));
        sum += s[nt][e];
      }
    l[h] = quad_sum(sum);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) s[nt][e] = __fdiv_rn(s[nt][e], l[h]);
  }
}

// One key tile of the pass that finds each row's max m and this thread's
// share of its sum l, l rescaled as m grows (quad_sum the shares after the
// last tile). m is finite from the first tile on: it holds key 0.
template <int NT>
__device__ __forceinline__ void online_max_sum(const float (&s)[NT][4], float (&m)[2],
                                               float (&l)[2]) {
  using namespace attn_mma;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
    const float m_new = fmaxf(m[h], quad_max(mx));
    float sum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) sum += expf(__fsub_rn(s[nt][e], m_new));
    l[h] = l[h] * expf(__fsub_rn(m[h], m_new)) + sum;
    m[h] = m_new;
  }
}

// bf16 forward on the tensor cores. DMAX: d rounded up to 64, 128 or 256.
// RESIDENT: t <= 128 and DMAX <= 128; K and V are staged whole and each
// warp's score rows stay in registers. Otherwise two passes over a ring of
// two K/V tiles of BK keys. VEC: stage with cp.async (see attention_mma.cuh).
template <int DMAX, bool VEC, bool RESIDENT>
__global__ void __launch_bounds__(attn_mma::kMmaThreads) short_fwd_mma_kernel(Args a) {
  using namespace attn_mma;
  constexpr int BK = RESIDENT ? 128 : (DMAX <= 128 ? 64 : 32);  // keys a K/V tile holds
  constexpr int NT = BK / 8;    // score fragments (8 keys each) of a warp
  constexpr int NV = DMAX / 8;  // output fragments (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int T_ = a.T, dp = round16(a.D), ld = tile_ld(dp);
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // (kMmaRows, ld)
  bf16* ks = qs + kMmaRows * ld;                  // RESIDENT: (BK, ld), else 2 x (BK, ld)
  bf16* vs = ks + (RESIDENT ? 1 : 2) * BK * ld;   // the same for V
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x, bi = bh / a.H, hi = bh % a.H;
  const int q0 = blockIdx.y * kMmaRows, wrow = q0 + warp * 16;
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.qs[0] + hi * a.qs[1];
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.ks[0] + hi * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.vs[0] + hi * a.vs[1];
  const float* bias = a.bias ? a.bias + (size_t)bi * T_ : nullptr;
  const bf16* qw = qs + warp * 16 * ld;

  // S of keys [k0, k0 + BK) from the K rows at kt
  auto scores = [&](float (&s)[NT][4], const bf16* kt, int k0, int pairs) {
    row_scores<NT, DMAX>(s, qw, kt, ld, dp, pairs, k0, T_, a.scale, bias);
  };

  float o[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nv][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  stage_tile<VEC>(qs, ld, q, a.qs[2], q0, kMmaRows, T_, a.D, dp);
  if constexpr (RESIDENT) {
    const int kr = round16(T_);  // key rows staged: t, and zeros up to a multiple of 16
    stage_tile<VEC>(ks, ld, k, a.ks[2], 0, kr, T_, a.D, dp);
    cp_async_commit();
    stage_tile<VEC>(vs, ld, v, a.vs[2], 0, kr, T_, a.D, dp);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed; V may still be in flight
    __syncthreads();
    float s[NT][4];
    scores(s, ks, 0, kr / 16);
    exact_softmax<NT>(s, m, l);
    uint32_t pa[NT / 2][4];
    scores_to_a<NT>(pa, s);  // P = e / l rounded to bf16
    cp_async_wait<0>();
    __syncthreads();
    warp_pv<NT, NV>(o, pa, vs, ld, dp, kr / 16);
  } else {
    const int n_tiles = (T_ + BK - 1) / BK;
    // pass 1: each row's max m and sum l over the K tiles
    stage_tile<VEC>(ks, ld, k, a.ks[2], 0, BK, T_, a.D, dp);
    cp_async_commit();
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j & 1;
      if (j + 1 < n_tiles)
        stage_tile<VEC>(ks + (st ^ 1) * BK * ld, ld, k, a.ks[2], (j + 1) * BK, BK, T_, a.D, dp);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      float s[NT][4];
      scores(s, ks + st * BK * ld, j * BK, NT / 2);
      online_max_sum<NT>(s, m, l);
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
    // pass 2: S again, P = round(exp(S - m) / l), O += P V
    stage_tile<VEC>(ks, ld, k, a.ks[2], 0, BK, T_, a.D, dp);
    stage_tile<VEC>(vs, ld, v, a.vs[2], 0, BK, T_, a.D, dp);
    cp_async_commit();
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j & 1;
      if (j + 1 < n_tiles) {
        stage_tile<VEC>(ks + (st ^ 1) * BK * ld, ld, k, a.ks[2], (j + 1) * BK, BK, T_, a.D, dp);
        stage_tile<VEC>(vs + (st ^ 1) * BK * ld, ld, v, a.vs[2], (j + 1) * BK, BK, T_, a.D, dp);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      float s[NT][4];
      scores(s, ks + st * BK * ld, j * BK, NT / 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = __fdiv_rn(expf(__fsub_rn(s[nt][e], m[e >> 1])), l[e >> 1]);
      uint32_t pa[NT / 2][4];
      scores_to_a<NT>(pa, s);
      warp_pv<NT, NV>(o, pa, vs + st * BK * ld, ld, dp, NT / 2);
      __syncthreads();
    }
  }
  bf16* out = static_cast<bf16*>(a.o) + bi * a.os[0] + hi * a.os[1];
  const float one[2] = {1.0f, 1.0f};  // P was normalised before the product
  store_rows<NV, VEC>(out, a.os[2], wrow, T_, a.D, o, one);
}

// ---------------------------------------------------------------- bf16 backward on the tensor cores
constexpr int kMmaBK = 64;  // keys per K/V tile of the dq passes, and per dk/dv block
constexpr int kStages = 2;  // stages of both backward rings

// Query rows of a Q/dO tile of the dk/dv kernel: 64, or 32 at heads wider
// than 64 so that the score tiles and the dK, dV accumulators fit in
// registers.
__host__ __device__ constexpr int dkv_rows(int dmax) { return dmax > 64 ? 32 : 64; }

// The dq kernel. DMAX: d rounded up to 64 or 128. RESIDENT: t <= 128; K and
// V are staged whole and each warp's S and dP rows stay in registers.
// Otherwise three passes over a ring of K/V tiles of kMmaBK keys. VEC:
// stage with cp.async (see attention_mma.cuh). Writes dq and each row's m,
// l and delta.
template <int DMAX, bool VEC, bool RESIDENT>
__global__ void __launch_bounds__(attn_mma::kMmaThreads) short_bwd_dq_kernel_mma(Args a) {
  using namespace attn_mma;
  constexpr int BK = RESIDENT ? 128 : kMmaBK;  // keys a K/V tile holds
  constexpr int NT = BK / 8;    // score fragments (8 keys each) of a warp
  constexpr int NV = DMAX / 8;  // dQ fragments (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int T_ = a.T, dp = round16(a.D), ld = tile_ld(dp);
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);         // (kMmaRows, ld)
  bf16* dos = qs + kMmaRows * ld;                        // (kMmaRows, ld)
  bf16* ks = dos + kMmaRows * ld;                        // RESIDENT: (BK, ld), else 2 x (BK, ld)
  bf16* vs = ks + (RESIDENT ? 1 : kStages) * BK * ld;    // the same for V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, bi = bh / a.H, hi = bh % a.H;
  const int q0 = blockIdx.y * kMmaRows, wrow = q0 + warp * 16;
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.qs[0] + hi * a.qs[1];
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.ks[0] + hi * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.vs[0] + hi * a.vs[1];
  const bf16* dout = static_cast<const bf16*>(a.dout) + bi * a.dos[0] + hi * a.dos[1];
  const float* bias = a.bias ? a.bias + (size_t)bi * T_ : nullptr;
  const bf16* qw = qs + warp * 16 * ld;
  const bf16* dow = dos + warp * 16 * ld;

  // S of keys [k0, k0 + BK) from the K rows at kt
  auto scores = [&](float (&s)[NT][4], const bf16* kt, int k0, int pairs) {
    row_scores<NT, DMAX>(s, qw, kt, ld, dp, pairs, k0, T_, a.scale, bias);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, delta[2] = {0.0f, 0.0f};
  float acc[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nv][e] = 0.0f;

  if constexpr (RESIDENT) {
    const int kr = round16(T_);  // key rows staged: t, and zeros up to a multiple of 16
    stage_tile<VEC>(qs, ld, q, a.qs[2], q0, kMmaRows, T_, a.D, dp);
    stage_tile<VEC>(ks, ld, k, a.ks[2], 0, kr, T_, a.D, dp);
    cp_async_commit();
    stage_tile<VEC>(dos, ld, dout, a.dos[2], q0, kMmaRows, T_, a.D, dp);
    stage_tile<VEC>(vs, ld, v, a.vs[2], 0, kr, T_, a.D, dp);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed; dO and V may still be in flight
    __syncthreads();
    float s[NT][4];
    scores(s, ks, 0, kr / 16);
    exact_softmax<NT>(s, m, l);
    cp_async_wait<0>();
    __syncthreads();
    float dpv[NT][4];
    warp_scores<NT, DMAX>(dpv, dow, ld, vs, ld, dp, kr / 16);  // dP = dO V^T
    // delta = rowsum(dP * P), then dS
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) part = fmaf(dpv[nt][e], s[nt][e], part);
      delta[h] = quad_sum(part);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpv[nt][e] = dscore_f32(s[nt][e], dpv[nt][e], delta[e >> 1], a.scale);
    uint32_t dsa[NT / 2][4];
    scores_to_a<NT>(dsa, dpv);  // dS rounded to bf16
    warp_pv<NT, NV>(acc, dsa, ks, ld, dp, kr / 16);  // dQ += dS K
  } else {
    const int n = (T_ + BK - 1) / BK;  // key tiles a pass
    const int steps = 3 * n;
    // step j: pass j / n over key tile j % n into stage st, one commit group
    // each (empty past the last step); the first pass reads K only
    auto stage_step = [&](int j, int st) {
      if (j < steps) {
        const int k0 = (j % n) * BK;
        stage_tile<VEC>(ks + st * BK * ld, ld, k, a.ks[2], k0, BK, T_, a.D, dp);
        if (j >= n) stage_tile<VEC>(vs + st * BK * ld, ld, v, a.vs[2], k0, BK, T_, a.D, dp);
      }
      cp_async_commit();
    };
    stage_tile<VEC>(qs, ld, q, a.qs[2], q0, kMmaRows, T_, a.D, dp);
    stage_tile<VEC>(dos, ld, dout, a.dos[2], q0, kMmaRows, T_, a.D, dp);
    stage_step(0, 0);  // Q and dO join the first tile's group
    float part[2] = {0.0f, 0.0f};
    for (int j = 0; j < steps; ++j) {
      const int st = j & 1, pass = j / n, k0 = (j - pass * n) * BK;
      stage_step(j + 1, st ^ 1);  // into the stage read last step
      cp_async_wait<1>();         // this step's tile has landed
      __syncthreads();
      const bf16* kt = ks + st * BK * ld;
      float s[NT][4];
      scores(s, kt, k0, NT / 2);
      if (pass == 0) {  // each row's max m and sum l
        online_max_sum<NT>(s, m, l);
        if (j == n - 1)
#pragma unroll
          for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
      } else {
        float dpv[NT][4];
        warp_scores<NT, DMAX>(dpv, dow, ld, vs + st * BK * ld, ld, dp, NT / 2);  // dP = dO V^T
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = prob(s[nt][e], m[e >> 1], l[e >> 1]);
        if (pass == 1) {  // delta = rowsum(dP * P)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[e >> 1] = fmaf(dpv[nt][e], s[nt][e], part[e >> 1]);
          if (j == 2 * n - 1)
#pragma unroll
            for (int h = 0; h < 2; ++h) delta[h] = quad_sum(part[h]);
        } else {  // dS, then dQ += dS K
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpv[nt][e] = dscore_f32(s[nt][e], dpv[nt][e], delta[e >> 1], a.scale);
          uint32_t dsa[NT / 2][4];
          scores_to_a<NT>(dsa, dpv);  // dS rounded to bf16
          warp_pv<NT, NV>(acc, dsa, kt, ld, dp, NT / 2);
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
  }

  // each row's m, l and delta for the dk/dv kernel: one lane of the quad
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow + (lane >> 2) + 8 * h;
      if (row < T_) {
        const size_t at = (size_t)bh * T_ + row;
        a.m[at] = m[h];
        a.l[at] = l[h];
        a.delta[at] = delta[h];
      }
    }
  }
  bf16* dq = static_cast<bf16*>(a.dq) + bi * a.dqs[0] + hi * a.dqs[1];
  const float one[2] = {1.0f, 1.0f};
  store_rows<NV, VEC>(dq, a.dqs[2], wrow, T_, a.D, acc, one);
}

// The dk/dv kernel: a block per 64 keys, query tiles of dkv_rows(DMAX)
// rows in a ring of kStages, each with its rows' m, l and delta. At DMAX 64
// the launch bounds ask for 3 blocks an SM: ptxas fits the kernel in 168
// registers without a spill (unbounded it takes 186-190, room for 2).
template <int DMAX, bool VEC>
__global__ void __launch_bounds__(attn_mma::kMmaThreads, DMAX > 64 ? 2 : 3)
    short_bwd_dkv_kernel_mma(Args a) {
  using namespace attn_mma;
  constexpr int BK = kMmaBK, BQ = dkv_rows(DMAX), ST = kStages;
  constexpr int NT = BQ / 8;    // transposed score fragments (8 query columns each) of a warp
  constexpr int NV = DMAX / 8;  // dK, dV fragments (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int T_ = a.T, dp = round16(a.D), ld = tile_ld(dp);
  bf16* ks = reinterpret_cast<bf16*>(smem_mma);  // (BK, ld)
  bf16* vs = ks + BK * ld;                        // (BK, ld)
  bf16* qs = vs + BK * ld;                        // ST x (BQ, ld)
  bf16* dos = qs + ST * BQ * ld;                  // ST x (BQ, ld)
  float* rs = reinterpret_cast<float*>(dos + ST * BQ * ld);  // ST x (m, l, delta) x BQ

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, bi = bh / a.H, hi = bh % a.H;
  const int k0 = blockIdx.y * BK;
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.qs[0] + hi * a.qs[1];
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.ks[0] + hi * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.vs[0] + hi * a.vs[1];
  const bf16* dout = static_cast<const bf16*>(a.dout) + bi * a.dos[0] + hi * a.dos[1];
  const float* m_bh = a.m + (size_t)bh * T_;
  const float* l_bh = a.l + (size_t)bh * T_;
  const float* delta_bh = a.delta + (size_t)bh * T_;
  const int n_tiles = (T_ + BQ - 1) / BQ;

  // query tile `tile` (Q, dO, and its rows' m, l, delta) into stage st, one
  // commit group each (empty past the last tile)
  auto stage_queries = [&](int tile, int st) {
    if (tile < n_tiles) {
      const int r0 = tile * BQ;
      stage_tile<VEC>(qs + st * BQ * ld, ld, q, a.qs[2], r0, BQ, T_, a.D, dp);
      stage_tile<VEC>(dos + st * BQ * ld, ld, dout, a.dos[2], r0, BQ, T_, a.D, dp);
      for (int i = threadIdx.x; i < 3 * BQ; i += kMmaThreads) {
        const int which = i / BQ, r = i % BQ, row = r0 + r;
        const float* src = which == 0 ? m_bh : which == 1 ? l_bh : delta_bh;
        cp_async4(rs + (3 * st + which) * BQ + r, row < T_ ? src + row : src, row < T_ ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  stage_tile<VEC>(ks, ld, k, a.ks[2], k0, BK, T_, a.D, dp);
  stage_tile<VEC>(vs, ld, v, a.vs[2], k0, BK, T_, a.D, dp);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) stage_queries(t, t);  // K and V join the first group

  // this thread's keys: rows g and g + 8 of the warp's 16; their bias
  const int g = lane >> 2, col_lane = 2 * (lane & 3);
  const int kw = k0 + warp * 16, key0 = kw + g;
  float kb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    kb[h] = a.bias && key0 + 8 * h < T_ ? a.bias[(size_t)bi * T_ + key0 + 8 * h] : 0.0f;

  float adk[NV][4], adv[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nv][e] = adv[nv][e] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % ST;
    stage_queries(i + ST - 1, (i + ST - 1) % ST);  // into the stage read last iteration
    cp_async_wait<ST - 1>();                       // this tile has landed
    __syncthreads();

    const int r0 = i * BQ;
    const bf16* qt = qs + st * BQ * ld;
    const bf16* dot = dos + st * BQ * ld;
    const float* m_s = rs + 3 * st * BQ;
    const float* l_s = m_s + BQ;
    const float* delta_s = l_s + BQ;
    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns queries
    float s[NT][4], dpv[NT][4];
    warp_scores<NT, DMAX>(s, ks + warp * 16 * ld, ld, qt, ld, dp, NT / 2);
    warp_scores<NT, DMAX>(dpv, vs + warp * 16 * ld, ld, dot, ld, dp, NT / 2);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // m, l and delta of the query columns col_lane, col_lane + 1 of this fragment
      const float2 mv = *reinterpret_cast<const float2*>(m_s + nt * 8 + col_lane);
      const float2 lv = *reinterpret_cast<const float2*>(l_s + nt * 8 + col_lane);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + nt * 8 + col_lane);
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // query c of the pair: entries c (key0) and c + 2 (key0 + 8)
        const int row = r0 + nt * 8 + col_lane + c;
        const float mq = c ? mv.y : mv.x, lq = c ? lv.y : lv.x, dlq = c ? dl.y : dl.x;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = c + 2 * h;
          float x = __fmul_rn(s[nt][e], a.scale);
          if (a.bias) x = __fadd_rn(x, kb[h]);
          const float p = row >= T_ || key0 + 8 * h >= T_ ? 0.0f : prob(x, mq, lq);
          dpv[nt][e] = dscore_f32(p, dpv[nt][e], dlq, a.scale);  // dS^T
          s[nt][e] = p;
        }
      }
    }
    uint32_t pa[NT / 2][4], dsa[NT / 2][4];
    scores_to_a<NT>(pa, s);     // P^T rounded to bf16
    scores_to_a<NT>(dsa, dpv);  // dS^T rounded to bf16
    warp_pv<NT, NV>(adv, pa, dot, ld, dp, NT / 2);
    warp_pv<NT, NV>(adk, dsa, qt, ld, dp, NT / 2);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const float one[2] = {1.0f, 1.0f};
  bf16* dk = static_cast<bf16*>(a.dk) + bi * a.dks[0] + hi * a.dks[1];
  bf16* dv = static_cast<bf16*>(a.dv) + bi * a.dvs[0] + hi * a.dvs[1];
  store_rows<NV, VEC>(dk, a.dks[2], kw, T_, a.D, adk, one);
  store_rows<NV, VEC>(dv, a.dvs[2], kw, T_, a.D, adv, one);
}

template <typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, int threads, size_t smem, const Args& a,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DMAX, bool VEC, bool RESIDENT>
cudaError_t forward_mma(const Args& a, cudaStream_t s) {
  using namespace attn_mma;
  constexpr int BK = RESIDENT ? 128 : (DMAX <= 128 ? 64 : 32);
  const size_t smem =
      sizeof(bf16) * (size_t)tile_ld(round16(a.D)) * (kMmaRows + (RESIDENT ? 2 : 4) * BK);
  const dim3 grid(a.B * a.H, (a.T + kMmaRows - 1) / kMmaRows);
  return run(short_fwd_mma_kernel<DMAX, VEC, RESIDENT>, grid, kMmaThreads, smem, a, s);
}

template <int DMAX, bool VEC>
cudaError_t forward_bf16(const Args& a, cudaStream_t s) {
  if constexpr (DMAX <= 128) {
    if (a.T <= 128) return forward_mma<DMAX, VEC, true>(a, s);
  }
  return forward_mma<DMAX, VEC, false>(a, s);
}

template <int DMAX>
cudaError_t forward_fp32(const Args& a, cudaStream_t s) {
  const dim3 grid((a.T + kFwdRows - 1) / kFwdRows, a.B * a.H);
  return run(short_fwd_kernel<DMAX / 16>, grid, kThreads, fwd_smem(a.T, a.D), a, s);
}

template <typename T, int DMAX>
cudaError_t backward(const Args& a, cudaStream_t s) {
  const dim3 grid_q((a.T + kDqRows - 1) / kDqRows, a.B * a.H);
  cudaError_t err = run(short_bwd_dq_kernel<T, DMAX / 16>, grid_q, kThreads, dq_smem(a.T, a.D),
                        a, s);
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.T + kKvKeys - 1) / kKvKeys, a.B * a.H);
  return run(short_bwd_dkv_kernel<T, DMAX / 8>, grid_k, kThreads, dkv_smem(a.D), a, s);
}

// The bf16 pair on the tensor cores: the dq kernel, then the dk/dv kernel.
template <int DMAX, bool VEC, bool RESIDENT>
cudaError_t backward_mma(const Args& a, cudaStream_t s) {
  using namespace attn_mma;
  constexpr int BK = RESIDENT ? 128 : kMmaBK, BQ = dkv_rows(DMAX);
  const size_t ld = tile_ld(round16(a.D));
  // dq: Q, dO and the K/V tiles; dk/dv: K, V and kStages of Q, dO, m, l, delta
  const size_t dq_smem =
      sizeof(bf16) * ld * (2 * kMmaRows + 2 * (RESIDENT ? 1 : kStages) * BK);
  const size_t dkv_smem =
      sizeof(bf16) * ld * (2 * kMmaBK + 2 * kStages * BQ) + sizeof(float) * kStages * 3 * BQ;
  static_assert(kMmaRows == kMmaBK, "both kernels tile the head by 64 rows");
  const dim3 grid(a.B * a.H, (a.T + kMmaRows - 1) / kMmaRows);
  cudaError_t err =
      run(short_bwd_dq_kernel_mma<DMAX, VEC, RESIDENT>, grid, kMmaThreads, dq_smem, a, s);
  if (err != cudaSuccess) return err;
  return run(short_bwd_dkv_kernel_mma<DMAX, VEC>, grid, kMmaThreads, dkv_smem, a, s);
}

template <int DMAX, bool VEC>
cudaError_t backward_bf16(const Args& a, cudaStream_t s) {
  if (a.T <= 128) return backward_mma<DMAX, VEC, true>(a, s);
  return backward_mma<DMAX, VEC, false>(a, s);
}

template <int DMAX>
cudaError_t forward(const Args& a, bool bf16, bool vec, cudaStream_t s) {
  if (!bf16) return forward_fp32<DMAX>(a, s);
  return vec ? forward_bf16<DMAX, true>(a, s) : forward_bf16<DMAX, false>(a, s);
}

cudaError_t dispatch_fwd(const Args& a, bool bf16, bool vec, cudaStream_t s) {
  if (a.D <= 64) return forward<64>(a, bf16, vec, s);
  if (a.D <= 128) return forward<128>(a, bf16, vec, s);
  return forward<256>(a, bf16, vec, s);
}

// By dtype and width alone: float32 on the CUDA cores; bf16 on the tensor
// cores up to d = 128, on the CUDA cores beyond.
cudaError_t dispatch_bwd(const Args& a, bool bf16, bool vec, cudaStream_t s) {
  if (!bf16) {
    if (a.D <= 64) return backward<float, 64>(a, s);
    if (a.D <= 128) return backward<float, 128>(a, s);
    return backward<float, 256>(a, s);
  }
  if (a.D <= 64) return vec ? backward_bf16<64, true>(a, s) : backward_bf16<64, false>(a, s);
  if (a.D <= 128) return vec ? backward_bf16<128, true>(a, s) : backward_bf16<128, false>(a, s);
  return backward<__nv_bfloat16, 256>(a, s);
}

bool valid(int B, int H, int T_, int D) {
  return B >= 1 && H >= 1 && T_ >= 1 && D >= 1 && T_ <= kMaxSeq && D <= kMaxDim &&
         (long long)B * H <= 65535;
}

void copy3(long long* dst, const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 values in elements, the
// (batch, head, time) strides of q, k, v and o; the last dimension is
// contiguous. bias (B, T) fp32 may be null. vec: the bf16 kernel stages with
// 16-byte cp.async copies, which needs every row of q, k, v and o to start
// on a 16-byte boundary and d % 8 == 0 (refused otherwise); 0 stages element
// by element. The float32 kernel stages element by element either way.
// Returns the launch's cudaError_t.
extern "C" int dl4j_short_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                        const float* bias, void* o, int B, int H, int T, int D,
                                        const long long* strides, float scale, int vec,
                                        void* stream) {
  if (!valid(B, H, T, D) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.o = o;
  a.B = B, a.H = H, a.T = T, a.D = D, a.scale = scale;
  copy3(a.qs, strides), copy3(a.ks, strides + 3), copy3(a.vs, strides + 6);
  copy3(a.os, strides + 9);
  const bool bf16 = dtype == 1;
  if (bf16 && vec &&
      !(attn_mma::rows_vectorizable(q, a.qs, B, H, T, D) &&
        attn_mma::rows_vectorizable(k, a.ks, B, H, T, D) &&
        attn_mma::rows_vectorizable(v, a.vs, B, H, T, D) &&
        attn_mma::rows_vectorizable(o, a.os, B, H, T, D)))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_fwd(a, bf16, vec != 0, static_cast<cudaStream_t>(stream));
}

// The backward pair: the dq kernel, then the dk/dv kernel, on one stream.
// strides: 21 values, the (batch, head, time) strides of q, k, v, dO, dq, dk
// and dv; m, l, delta: fp32 scratch of B*H*T each. vec: the bf16
// tensor-core pair stages with 16-byte cp.async copies, which needs every
// row of the seven operands to start on a 16-byte boundary and d % 8 == 0
// (refused otherwise); 0 stages element by element. The CUDA-core pair
// stages element by element either way.
extern "C" int dl4j_short_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                        const void* dout, const float* bias, void* dq, void* dk,
                                        void* dv, float* m, float* l, float* delta, int B,
                                        int H, int T, int D, const long long* strides,
                                        float scale, int vec, void* stream) {
  if (!valid(B, H, T, D) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.bias = bias;
  a.dq = dq, a.dk = dk, a.dv = dv, a.m = m, a.l = l, a.delta = delta;
  a.B = B, a.H = H, a.T = T, a.D = D, a.scale = scale;
  copy3(a.qs, strides), copy3(a.ks, strides + 3), copy3(a.vs, strides + 6);
  copy3(a.dos, strides + 9), copy3(a.dqs, strides + 12), copy3(a.dks, strides + 15);
  copy3(a.dvs, strides + 18);
  const bool bf16 = dtype == 1;
  if (bf16 && vec) {  // the launcher's claim, re-checked: a misaligned cp.async loses the context
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    for (int t = 0; t < 7; ++t)
      if (!attn_mma::rows_vectorizable(ptrs[t], strides + 3 * t, B, H, T, D))
        return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch_bwd(a, bf16, vec != 0, static_cast<cudaStream_t>(stream));
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
