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
// 2 x 2 x 768 x 128^2 x 64 = 3.2 GFLOP, 3.3 us at 989 TFLOP/s: bytes. At
// T=4096 causal (B=1, h=12, d=64): 25.8 GFLOP of attended pairs, 26 us at
// 989 TFLOP/s, against 25 MB, 7.5 us: operations.
//
// Design, bf16 (flash_fwd_mma_kernel): one block of 4 warps per (batch *
// head, query tile of 64 rows), the heaviest causal tiles launched first.
// Each warp owns 16 query rows. Q, K and V reach shared memory as bf16
// through cp.async (attention_mma.cuh), K/V in a ring of two tiles so the
// next tile loads while the current one is multiplied; S = Q K^T and
// O += P V run on mma.sync m16n8k16 (bf16 operands, fp32 sums). The score
// fragments stay in registers: the scale and the bias (loaded before the
// product, so its latency hides behind it) are applied there, the row max
// and sum are combined across the 4 lanes of a quad, and the unnormalised
// P = exp(S - m), by one ex2.approx each, is rounded to bf16 straight into
// the A fragments of P V (FlashAttention-2), so P never goes through shared
// memory. d and d_v are padded to multiples of 16 with zeros in shared
// memory. Views whose rows do not start on a 16-byte boundary (d % 8 != 0,
// an offset view) are staged element by element into the same layout: the
// launcher sets VEC from the pointers and strides.
//
// float32 (flash_fwd_kernel, the card's check of the algorithm) stays on the
// CUDA cores in full fp32 with expf: 256 threads per (query tile of 64
// rows, batch * head), Q and K staged transposed as fp32, 4x4 register
// tiles of FMAs, P through shared memory.
//
// On an H100 (700 W) the bf16 kernel takes 0.039 ms at BERT-base (39% of
// its byte bound; SDPA 0.021) and 0.22 ms at T=4096 causal (12% of its
// operation bound; SDPA 0.082). What still holds it back: mma.sync, which
// reaches a fraction of the rate wgmma reaches; at BERT-base each block's
// short life (two key tiles) leaves the first loads' latency exposed, and
// the two query tiles of a head each read its K and V. wgmma with TMA
// rings and a producer warp is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

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

size_t smem_bytes(int D, int dmax) {
  return sizeof(float) * ((size_t)D * kQS + (size_t)D * kKS + (size_t)kBK * dmax +
                          (size_t)kBK * kQS);
}

// float32 on the CUDA cores. DMAX: d and d_v rounded up to 64, 128 or 256
// (the accumulator's width).
template <int DMAX, bool CAUSAL, bool SAVE>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int G = DMAX / 64;  // 4-column groups of the accumulator per thread
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  float* qt = smem;              // (D, kQS) Q tile, transposed
  float* kt = qt + D * kQS;      // (D, kKS) K tile, transposed
  float* vt = kt + D * kKS;      // (kBK, DMAX) V tile, zero past d_v and t_k
  float* pt = vt + kBK * DMAX;   // (kBK, kQS) P tile, transposed

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int q0 = blockIdx.x * kBQ;
  const float* q = static_cast<const float*>(a.q) + bi * a.qs[0] + hi * a.qs[1];
  const float* k = static_cast<const float*>(a.k) + bi * a.ks[0] + hi * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + bi * a.vs[0] + hi * a.vs[1];
  float* o = static_cast<float*>(a.o) + bi * a.os[0] + hi * a.os[1];
  const float* bias = a.bias ? a.bias + (size_t)bi * a.Tk : nullptr;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qt[c * kQS + r] = q0 + r < a.Tq ? q[(long long)(q0 + r) * a.qs[2] + c] : 0.0f;
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
      kt[c * kKS + r] = r < nk ? k[(long long)(k0 + r) * a.ks[2] + c] : 0.0f;
    }
    for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
      const int r = idx / DMAX, c = idx % DMAX;
      vt[idx] = r < nk && c < a.Dv ? v[(long long)(k0 + r) * a.vs[2] + c] : 0.0f;
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
      const float4 pv = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
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
    float* orow = o + (long long)row * a.os[2];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = g * 64 + tx * 4 + j;
        if (col < a.Dv) orow[col] = acc[i][g * 4 + j] / ls;
      }
    if (SAVE && tx == 0) a.lse[(size_t)bh * a.Tq + row] = m[i] + logf(ls);
  }
}

// bf16 on the tensor cores. DMAX: d and d_v rounded up to 64, 128 or 256;
// BK keys per K/V tile (32 at DMAX 256, so that the score and accumulator
// fragments fit in registers). VEC: stage with cp.async (see the header).
template <int DMAX, bool CAUSAL, bool VEC>
__global__ void __launch_bounds__(attn_mma::kMmaThreads) flash_fwd_mma_kernel(Args a) {
  using namespace attn_mma;
  constexpr int BK = DMAX <= 128 ? 64 : 32;
  constexpr int NT = BK / 8;    // score fragments (8 keys each) of a warp
  constexpr int NV = DMAX / 8;  // accumulator fragments (8 columns each)
  constexpr int BQ = kMmaRows;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int dp = round16(a.D), dvp = round16(a.Dv);
  const int qld = tile_ld(dp), vld = tile_ld(dvp);
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // (BQ, qld)
  bf16* ks = qs + BQ * qld;                       // 2 x (BK, qld)
  bf16* vs = ks + 2 * BK * qld;                   // 2 x (BK, vld)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, bi = bh / a.H, hi = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.qs[0] + hi * a.qs[1];
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.ks[0] + hi * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.vs[0] + hi * a.vs[1];
  const float* bias = a.bias ? a.bias + (size_t)bi * a.Tk : nullptr;

  int n_tiles = (a.Tk + BK - 1) / BK;
  if (CAUSAL) n_tiles = min(n_tiles, (min(q0 + BQ, a.Tq) + BK - 1) / BK);

  stage_tile<VEC>(qs, qld, q, a.qs[2], q0, BQ, a.Tq, a.D, dp);
  stage_tile<VEC>(ks, qld, k, a.ks[2], 0, BK, a.Tk, a.D, dp);
  stage_tile<VEC>(vs, vld, v, a.vs[2], 0, BK, a.Tk, a.Dv, dvp);
  cp_async_commit();

  float o[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nv][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // l: this thread's share
  const int wrow = q0 + warp * 16;                            // the warp's first row
  const int row0 = wrow + (lane >> 2), key_lane = 2 * (lane & 3);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // the next tile into the other stage
      stage_tile<VEC>(ks + (st ^ 1) * BK * qld, qld, k, a.ks[2], (j + 1) * BK, BK, a.Tk, a.D, dp);
      stage_tile<VEC>(vs + (st ^ 1) * BK * vld, vld, v, a.vs[2], (j + 1) * BK, BK, a.Tk, a.Dv,
                      dvp);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();

    const int k0 = j * BK;
    float bv[NT][2];
    if (bias) load_bias<NT>(bv, bias, k0, a.Tk);
    float s[NT][4];
    warp_scores<NT, DMAX>(s, qs + warp * 16 * qld, qld, ks + st * BK * qld, qld, dp, NT / 2);
    // keys past t_k, and causally excluded keys, only in an edge tile
    const bool edge = k0 + BK > a.Tk || (CAUSAL && k0 + BK - 1 > wrow);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // key c of the pair: entries c (row0) and c + 2 (row0 + 8)
        const int key = k0 + nt * 8 + key_lane + c;
        const bool past = edge && key >= a.Tk;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = __fmul_rn(s[nt][c + 2 * h], a.scale);
          if (past || (CAUSAL && edge && key > row0 + 8 * h)) {
            x = -INFINITY;
          } else if (bias) {
            x = __fadd_rn(x, bv[nt][c]);
          }
          s[nt][c + 2 * h] = x;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows row0 + 8 h: fragment entries 2 h, 2 h + 1
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));
      // a row that has seen no key yet keeps weight 0 everywhere
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = expf(m[h] - m_use);
      float rs = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp_approx(s[nt][e] - m_use);
          s[nt][e] = p;
          rs += p;
        }
      l[h] = l[h] * corr + rs;
      m[h] = m_new;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        o[nv][2 * h] *= corr;
        o[nv][2 * h + 1] *= corr;
      }
    }
    uint32_t pa[NT / 2][4];
    scores_to_a<NT>(pa, s);  // unnormalised P rounded to bf16; l summed it unrounded
    warp_pv<NT, NV>(o, pa, vs + st * BK * vld, vld, dvp, NT / 2);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float ls[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) ls[h] = fmaxf(quad_sum(l[h]), 1e-20f);
  bf16* out = static_cast<bf16*>(a.o) + bi * a.os[0] + hi * a.os[1];
  store_rows<NV, VEC>(out, a.os[2], wrow, a.Tq, a.Dv, o, ls);
  if (a.lse && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < a.Tq) a.lse[(size_t)bh * a.Tq + row] = m[h] + logf(ls[h]);
    }
  }
}

template <int DMAX, bool CAUSAL, bool SAVE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D, DMAX);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DMAX, CAUSAL, SAVE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.B * a.H);
  flash_fwd_kernel<DMAX, CAUSAL, SAVE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DMAX, bool CAUSAL, bool VEC>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  using namespace attn_mma;
  constexpr int BK = DMAX <= 128 ? 64 : 32;
  const int qld = tile_ld(round16(a.D)), vld = tile_ld(round16(a.Dv));
  const size_t smem = sizeof(bf16) * ((size_t)kMmaRows * qld + 2 * (size_t)BK * (qld + vld));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<DMAX, CAUSAL, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Tq + kMmaRows - 1) / kMmaRows);
  flash_fwd_mma_kernel<DMAX, CAUSAL, VEC><<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t dispatch_fp32(const Args& a, bool causal, cudaStream_t s) {
  if (causal) return a.lse ? launch<DMAX, true, true>(a, s) : launch<DMAX, true, false>(a, s);
  return a.lse ? launch<DMAX, false, true>(a, s) : launch<DMAX, false, false>(a, s);
}

template <int DMAX>
cudaError_t dispatch_bf16(const Args& a, bool causal, bool vec, cudaStream_t s) {
  if (causal) return vec ? launch_mma<DMAX, true, true>(a, s) : launch_mma<DMAX, true, false>(a, s);
  return vec ? launch_mma<DMAX, false, true>(a, s) : launch_mma<DMAX, false, false>(a, s);
}

cudaError_t dispatch(const Args& a, bool bf16, bool causal, bool vec, cudaStream_t s) {
  const int widest = a.D > a.Dv ? a.D : a.Dv;
  if (!bf16) {
    if (widest <= 64) return dispatch_fp32<64>(a, causal, s);
    if (widest <= 128) return dispatch_fp32<128>(a, causal, s);
    return dispatch_fp32<256>(a, causal, s);
  }
  if (widest <= 64) return dispatch_bf16<64>(a, causal, vec, s);
  if (widest <= 128) return dispatch_bf16<128>(a, causal, vec, s);
  return dispatch_bf16<256>(a, causal, vec, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias (B, Tk) fp32 may be null; lse
// (B, H, Tq) fp32 is null for the inference instance and set for the saving
// instance. Strides are in elements, per (batch, head, time); the last
// dimension of q, k, v and o must be contiguous. causal needs Tq == Tk. vec:
// the bf16 kernel stages with 16-byte cp.async copies, which needs every row
// of q, k, v and o to start on a 16-byte boundary with d and d_v multiples
// of 8 (refused otherwise); 0 stages element by element. The float32 kernel
// stages element by element either way.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dl4j_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                              const float* bias, void* o, float* lse, int B, int H, int Tq,
                              int Tk, int D, int Dv, long long q_sb, long long q_sh,
                              long long q_st, long long k_sb, long long k_sh, long long k_st,
                              long long v_sb, long long v_sh, long long v_st, long long o_sb,
                              long long o_sh, long long o_st, float scale, int causal, int vec,
                              void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || Dv < 1 || D > kMaxDim ||
      Dv > kMaxDim || (long long)B * H > 65535 || (causal && Tq != Tk) ||
      (Tq + kBQ - 1) / kBQ > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, bias, o, lse, B, H, Tq, Tk, D, Dv,
         {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st}, {v_sb, v_sh, v_st}, {o_sb, o_sh, o_st},
         scale};
  const bool bf16 = dtype == 1;
  if (bf16 && vec &&
      !(attn_mma::rows_vectorizable(q, a.qs, B, H, Tq, D) &&
        attn_mma::rows_vectorizable(k, a.ks, B, H, Tk, D) &&
        attn_mma::rows_vectorizable(v, a.vs, B, H, Tk, Dv) &&
        attn_mma::rows_vectorizable(o, a.os, B, H, Tq, Dv)))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(a, bf16, causal != 0, vec != 0, static_cast<cudaStream_t>(stream));
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
