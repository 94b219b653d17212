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
// Design (first version: right and simple; CUDA-core products, 256
// threads a block, operands staged in shared memory as fp32):
//   - forward: a block per (32-query tile, batch * head) keeps its rows'
//     whole score rows (32 x t fp32 <= 64 KB) in shared memory: S tile by
//     tile of 64 staged keys, then the exact softmax (8 threads a row), then
//     round(P) @ V tile by tile of 64 staged values;
//   - backward, two kernels. dK and dV sum over every query, and a block
//     cannot keep a (t, d) fp32 sum for all of them, so the work is split:
//     (1) a dq kernel, a block per (16-query tile, batch * head), forms its
//     rows' S and dP, the softmax, delta and dS = round(...), writes each
//     row's m, l and delta (fp32 scratch of 3 x (B*H, t), made by the
//     wrapper) and dQ = dS K; (2) a dk/dv kernel, a block per (32-key tile,
//     batch * head), walks the query tiles of 16, recomputes S and dP for
//     its keys with the same device functions in the same order, and from
//     the saved m, l and delta gets the same P and dS bit for bit, and sums
//     dV and dK in registers. Nothing of the forward is read: the autograd
//     Function saves q, k, v and the mask only.
// Tensor cores (mma/wgmma), TMA and bf16 operands in shared memory are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// dS of one entry, rounded to T
template <typename T>
__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return round_to<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale));
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

// NJ: output columns per thread in steps of 16 (DMAX / 16, DMAX = 64, 128 or 256)
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) short_fwd_kernel(Args a) {
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

template <typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t forward(const Args& a, cudaStream_t s) {
  const dim3 grid((a.T + kFwdRows - 1) / kFwdRows, a.B * a.H);
  return run(short_fwd_kernel<T, DMAX / 16>, grid, fwd_smem(a.T, a.D), a, s);
}

template <typename T, int DMAX>
cudaError_t backward(const Args& a, cudaStream_t s) {
  const dim3 grid_q((a.T + kDqRows - 1) / kDqRows, a.B * a.H);
  cudaError_t err = run(short_bwd_dq_kernel<T, DMAX / 16>, grid_q, dq_smem(a.T, a.D), a, s);
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.T + kKvKeys - 1) / kKvKeys, a.B * a.H);
  return run(short_bwd_dkv_kernel<T, DMAX / 8>, grid_k, dkv_smem(a.D), a, s);
}

template <typename T>
cudaError_t dispatch(const Args& a, bool bwd, cudaStream_t s) {
  if (a.D <= 64) return bwd ? backward<T, 64>(a, s) : forward<T, 64>(a, s);
  if (a.D <= 128) return bwd ? backward<T, 128>(a, s) : forward<T, 128>(a, s);
  return bwd ? backward<T, 256>(a, s) : forward<T, 256>(a, s);
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
// contiguous. bias (B, T) fp32 may be null. Returns the launch's cudaError_t.
extern "C" int dl4j_short_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                        const float* bias, void* o, int B, int H, int T, int D,
                                        const long long* strides, float scale, void* stream) {
  if (!valid(B, H, T, D)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.o = o;
  a.B = B, a.H = H, a.T = T, a.D = D, a.scale = scale;
  copy3(a.qs, strides), copy3(a.ks, strides + 3), copy3(a.vs, strides + 6);
  copy3(a.os, strides + 9);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, false, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, false, s);
  return (int)cudaErrorInvalidValue;
}

// The backward pair: the dq kernel, then the dk/dv kernel, on one stream.
// strides: 21 values, the (batch, head, time) strides of q, k, v, dO, dq, dk
// and dv; m, l, delta: fp32 scratch of B*H*T each.
extern "C" int dl4j_short_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                        const void* dout, const float* bias, void* dq, void* dk,
                                        void* dv, float* m, float* l, float* delta, int B,
                                        int H, int T, int D, const long long* strides,
                                        float scale, void* stream) {
  if (!valid(B, H, T, D)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.bias = bias;
  a.dq = dq, a.dk = dk, a.dv = dv, a.m = m, a.l = l, a.delta = delta;
  a.B = B, a.H = H, a.T = T, a.D = D, a.scale = scale;
  copy3(a.qs, strides), copy3(a.ks, strides + 3), copy3(a.vs, strides + 6);
  copy3(a.dos, strides + 9), copy3(a.dqs, strides + 12), copy3(a.dks, strides + 15);
  copy3(a.dvs, strides + 18);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, true, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, true, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
