// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// deeplearning4j_tpu/ops/pallas/flash_attention.py, _flash_fwd (pallas_call
// at :226, kernel _fwd_kernel :143): per (batch, head)
//   O = softmax(Q K^T * scale + bias [+ causal]) V,   scale = 1 / sqrt(d)
// without ever holding the (t_q, t_k) score matrix in device memory, and,
// for the saving instance (SAVE), the per-row logsumexp lse = m + log(l)
// that the backward reads.
//
// Semantics, as the Pallas kernel's:
//   - bias is an additive key-padding bias (B, t_k) in fp32, shared by the
//     heads of a batch row (0 where a key is attended, -1e30 where not);
//   - causal is the top-left triangle (key <= query) and needs t_q == t_k;
//     key tiles past a query tile's diagonal are skipped;
//   - the products read Q, K, V and P in the storage type T; scores, the
//     running max m and sum l, and the accumulator are fp32. P is rounded
//     to T before P @ V, l sums the unrounded P;
//   - O = acc / max(l, 1e-20), stored in T; lse in fp32;
//   - a fully masked row (every key biased by -1e30) gives the mean of V.
// Keys past t_k in the last tile and causally excluded keys weigh exactly 0.
// Ragged t_q and t_k of any length >= 1 are handled by bounds checks: no
// tile-multiple limit. d and d_v (which may differ) are 1..256; T is float
// or bf16. Anything else is refused with cudaErrorInvalidValue.
//
// Layout: Q, K, V and O are read and written through (batch, head, time)
// strides in elements with a unit stride along d, so the (b, t, h*d) output
// of a projection is read without transposing it, and O can be written
// straight into the (b, t, h*d_v) layout the next projection reads.
//
// Bound at the BERT-base serving shape (B=64, h=12, T=128, d=64, bf16):
// q, k, v and o are 4 x 12.6 MB = 50 MB, 15 us at 3.35 TB/s, against
// 2 x 2 x 768 x 128^2 x 64 = 3.2 GFLOP, 3.3 us at 989 TFLOP/s: bytes.
//
// Design (first version: right and simple): one block of 256 threads per
// (query tile of 64 rows, batch * head). The Q tile is staged once in
// shared memory, transposed, in fp32; the block then walks the key/value
// tiles of 64 keys, staging K (transposed) and V in shared memory, and runs
// the online-softmax update with the row statistics in registers. Each
// thread owns 4 query rows x 4 keys of the score tile and 4 rows x d_v/16
// columns of the accumulator; the 16 threads that share rows reduce the
// row max and sum with warp shuffles. Products run on the CUDA cores in
// fp32 from 16-byte shared-memory loads. Tensor cores (mma/wgmma), TMA and
// a pipelined tile ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kPad = 4;          // row padding of the transposed tiles (keeps 16 B alignment)
constexpr int kQS = kBQ + kPad;  // row stride of the transposed Q and P tiles
constexpr int kKS = kBK + kPad;  // row stride of the transposed K tile
constexpr int kMaxDim = 256;

struct Args {
  const void* q;      // (B, H, Tq, D) through qs
  const void* k;      // (B, H, Tk, D) through ks
  const void* v;      // (B, H, Tk, Dv) through vs
  const float* bias;  // (B, Tk) or null
  void* o;            // (B, H, Tq, Dv) through os
  float* lse;         // (B, H, Tq) contiguous, SAVE only
  int B, H, Tq, Tk, D, Dv;
  long long qs[3], ks[3], vs[3], os[3];  // batch, head, time strides in elements
  float scale;
};

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

size_t smem_bytes(int D, int dmax) {
  return sizeof(float) * ((size_t)D * kQS + (size_t)D * kKS + (size_t)kBK * dmax +
                          (size_t)kBK * kQS);
}

// DMAX: d and d_v rounded up to 64, 128 or 256 (the accumulator's width).
template <typename T, int DMAX, bool CAUSAL, bool SAVE>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int G = DMAX / 64;  // 4-column groups of the accumulator per thread
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  float* qt = smem;              // (D, kQS) Q tile, transposed
  float* kt = qt + D * kQS;      // (D, kKS) K tile, transposed
  float* vt = kt + D * kKS;      // (kBK, DMAX) V tile, zero past d_v and t_k
  float* pt = vt + kBK * DMAX;   // (kBK, kQS) P tile, transposed, rounded to T

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int q0 = blockIdx.x * kBQ;
  const T* q = static_cast<const T*>(a.q) + bi * a.qs[0] + hi * a.qs[1];
  const T* k = static_cast<const T*>(a.k) + bi * a.ks[0] + hi * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + bi * a.vs[0] + hi * a.vs[1];
  T* o = static_cast<T*>(a.o) + bi * a.os[0] + hi * a.os[1];
  const float* bias = a.bias ? a.bias + (size_t)bi * a.Tk : nullptr;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qt[c * kQS + r] = q0 + r < a.Tq ? to_f(q[(long long)(q0 + r) * a.qs[2] + c]) : 0.0f;
  }

  float acc[4][4 * G];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.0f;
  }

  int n_tiles = (a.Tk + kBK - 1) / kBK;
  if (CAUSAL) n_tiles = min(n_tiles, (min(q0 + kBQ, a.Tq) + kBK - 1) / kBK);

  for (int kti = 0; kti < n_tiles; ++kti) {
    const int k0 = kti * kBK;
    const int nk = min(kBK, a.Tk - k0);
    __syncthreads();  // the previous tile's readers of kt, vt and pt are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      kt[c * kKS + r] = r < nk ? to_f(k[(long long)(k0 + r) * a.ks[2] + c]) : 0.0f;
    }
    for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
      const int r = idx / DMAX, c = idx % DMAX;
      vt[idx] = r < nk && c < a.Dv ? to_f(v[(long long)(k0 + r) * a.vs[2] + c]) : 0.0f;
    }
    __syncthreads();

    // S = Q K^T: rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + c * kQS + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(kt + c * kKS + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // online softmax over this tile, one row at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        float x = s[i][j] * a.scale;
        if (key >= a.Tk || (CAUSAL && key > row)) {
          x = -INFINITY;
        } else if (bias) {
          x += bias[key];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen no key yet keeps weight 0 everywhere
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = expf(m[i] - m_use);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        rs += p;
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 pv = make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]),
                                    round_to<T>(s[2][j]), round_to<T>(s[3][j]));
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kQS + ty * 4) = pv;
    }
    __syncthreads();

    // acc += P V: rows ty*4+i, columns g*64 + tx*4 + j
    for (int kk = 0; kk < nk; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + kk * kQS + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(vt + kk * DMAX + g * 64 + tx * 4);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][g * 4 + j] = fmaf(pa[i], va[j], acc[i][g * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Tq) continue;
    const float ls = fmaxf(l[i], 1e-20f);
    T* orow = o + (long long)row * a.os[2];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = g * 64 + tx * 4 + j;
        if (col < a.Dv) orow[col] = from_f<T>(acc[i][g * 4 + j] / ls);
      }
    if (SAVE && tx == 0) a.lse[(size_t)bh * a.Tq + row] = m[i] + logf(ls);
  }
}

template <typename T, int DMAX, bool CAUSAL, bool SAVE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D, DMAX);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX, CAUSAL, SAVE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.B * a.H);
  flash_fwd_kernel<T, DMAX, CAUSAL, SAVE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t dispatch_flags(const Args& a, bool causal, cudaStream_t s) {
  if (causal) return a.lse ? launch<T, DMAX, true, true>(a, s) : launch<T, DMAX, true, false>(a, s);
  return a.lse ? launch<T, DMAX, false, true>(a, s) : launch<T, DMAX, false, false>(a, s);
}

template <typename T>
cudaError_t dispatch(const Args& a, bool causal, cudaStream_t s) {
  const int widest = a.D > a.Dv ? a.D : a.Dv;
  if (widest <= 64) return dispatch_flags<T, 64>(a, causal, s);
  if (widest <= 128) return dispatch_flags<T, 128>(a, causal, s);
  return dispatch_flags<T, 256>(a, causal, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias (B, Tk) fp32 may be null; lse
// (B, H, Tq) fp32 is null for the inference instance and set for the saving
// instance. Strides are in elements, per (batch, head, time); the last
// dimension of q, k, v and o must be contiguous. causal needs Tq == Tk.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dl4j_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                              const float* bias, void* o, float* lse, int B, int H, int Tq,
                              int Tk, int D, int Dv, long long q_sb, long long q_sh,
                              long long q_st, long long k_sb, long long k_sh, long long k_st,
                              long long v_sb, long long v_sh, long long v_st, long long o_sb,
                              long long o_sh, long long o_st, float scale, int causal,
                              void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || Dv < 1 || D > kMaxDim ||
      Dv > kMaxDim || (long long)B * H > 65535 || (causal && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, bias, o, lse, B, H, Tq, Tk, D, Dv,
         {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st}, {v_sb, v_sh, v_st}, {o_sb, o_sh, o_st},
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, causal != 0, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, causal != 0, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
