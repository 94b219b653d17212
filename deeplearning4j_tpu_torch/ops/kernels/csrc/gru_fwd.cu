// Persistent GRU forward recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas/fused_gru.py,
// _gru_fwd (pallas_call at :147, kernel _fwd_kernel :85): the reset-after
// cell with no recurrent bias and no mask. T is the storage type (float or
// bf16). SAVE (training) also writes the residuals the backward kernel
// (gru_bwd.cu) reads, as the Pallas kernel does with save_residuals=True: the
// activated gates [r, u, n] (T, B, 3H) and the recurrent n pre-activation
// zh_n (T, B, H), both in T.
//
// Function, per step (gate order [r, u, n]):
//   zh  = round_T(h) @ W_rec            (products of T values, fp32 sum)
//   r   = sigmoid(zx_r + zh_r)          u = sigmoid(zx_u + zh_u)
//   n   = tanh(zx_n + r * zh_n)
//   h'  = (1 - u) * n + u * h
// h is carried in fp32, so u * h uses the unrounded carry, while the product
// reads h rounded to T, which is exactly what ys[t-1] holds (or h0 at t=0).
// ys and hT are stored in T.
//
// Bound at the char-RNN serving shape (B=64, T=256, H=512, bf16), per layer:
// 2*T*B*H*3H = 25.8 GFLOP, 26 us at 989 TFLOP/s; zx + ys + W_rec = 68.7 MB,
// 21 us at 3.35 TB/s (the saving instance also writes gates and zh_n: 136 MB,
// 41 us). Neither is what sets the pace: the 256 steps depend on each other,
// and every step ends in a grid-wide barrier.
//
// Design, lstm_fwd.cu's: one cooperative launch per layer per sequence (per
// group of at most `rows` batch rows). Block b owns hidden units
// [b*U, b*U+U) and pins the 3U columns j, H+j, 2H+j of W_rec for them in
// shared memory for all T steps, stored as rows (12 KB at U=4, H=512, bf16),
// so r, u, zh_n, n and h' of its units are all computed in the block. Its
// units' fp32 h carry stays in shared memory. At step t the block stages
// h_{t-1} of every row from ys[t-1] (L2, written by all blocks) with 16-byte
// loads, computes its 3U recurrent products for every row on the CUDA cores,
// applies the cell, writes its units of ys[t], and waits at the grid barrier.
// The saving instance keeps the step's residuals in shared memory and
// stores them after the barrier, where they drain while the next step
// computes. Tensor cores, TMA and clusters are left for later work.
//
// Limits: a shape whose W_rec slices cannot all be resident at once is
// refused with cudaErrorInvalidConfiguration, and the wrapper raises.

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace dl4j_lstm;

namespace {

struct Args {
  const void* zx;  // (T, B, 3H)
  const void* w;   // (H, 3H)
  const void* h0;  // (B, H)
  void* ys;        // (T, B, H)
  void* hT;        // (B, H)
  void* gates;     // (T, B, 3H) activated [r, u, n], or null: SAVE only
  void* zhn;       // (T, B, H) recurrent n pre-activation, or null: SAVE only
  int T, B, H;
  int r0, rows;    // batch rows [r0, r0 + rows) handled by this launch
  int units;       // hidden units per block
  int chunk;       // rows of h staged in shared memory at once
};

template <typename T>
size_t smem_bytes(int H, int rows, int units, int chunk, bool save) {
  const int C = 3 * units;
  return sizeof(float) * ((size_t)rows * C + (size_t)rows * units) +
         sizeof(T) * ((save ? (size_t)rows * units * 4 : 0) +
                      ((size_t)C + chunk) * row_stride<T>(H));
}

template <typename T, bool SAVE>
__global__ void __launch_bounds__(kThreads) gru_fwd_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.units, C = 3 * U, H = a.H, R = a.rows, RC = a.chunk, B = a.B;
  const int S = row_stride<T>(H);
  float* zb = reinterpret_cast<float*>(smem);  // (R, C) recurrent products
  float* hown = zb + (size_t)R * C;            // (R, U) fp32 h carry
  T* gs = reinterpret_cast<T*>(hown + (size_t)R * U);  // (R*U, 4) [r, u, n, zh_n]: SAVE
  T* ws = gs + (SAVE ? (size_t)R * U * 4 : 0);         // (C, S) W_rec columns as rows
  T* hs = ws + (size_t)C * S;                          // (RC, S) staged h

  const T* zx = static_cast<const T*>(a.zx);
  const T* w = static_cast<const T*>(a.w);
  const T* h0 = static_cast<const T*>(a.h0);
  T* ys = static_cast<T*>(a.ys);
  T* hT = static_cast<T*>(a.hT);
  T* gates = static_cast<T*>(a.gates);
  T* zhn = static_cast<T*>(a.zhn);
  const int j0 = blockIdx.x * U;

  // Pin this block's columns: ws[g*U + u, k] = W_rec[k, g*H + j0 + u].
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int k = idx / C, col = idx % C, g = col / U, j = j0 + col % U;
    ws[(size_t)col * S + k] = j < H ? w[(size_t)k * 3 * H + (size_t)g * H + j] : from_f<T>(0.0f);
  }
  for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
    const int r = idx / U, j = j0 + idx % U;
    hown[idx] = j < H ? to_f(h0[(size_t)(a.r0 + r) * H + j]) : 0.0f;
  }
  __syncthreads();

  // SAVE: write step ts's residuals, kept in gs since before its barrier.
  // Each thread writes back what it put in gs.
  auto flush = [&](int ts) {
    for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
      const int j = j0 + idx % U;
      if (j >= H) continue;
      const size_t tb = (size_t)ts * B + a.r0 + idx / U;
      T* gr = gates + tb * 3 * H;
      const T* g = gs + (size_t)idx * 4;
      gr[j] = g[0];
      gr[H + j] = g[1];
      gr[2 * H + j] = g[2];
      zhn[tb * H + j] = g[3];
    }
  };

  for (int t = 0; t < a.T; ++t) {
    if (SAVE && t > 0) flush(t - 1);
    const T* hprev = t == 0 ? h0 : ys + (size_t)(t - 1) * B * H;
    for (int rc0 = 0; rc0 < R; rc0 += RC) {
      const int nr = min(RC, R - rc0);
      stage_rows(hs, S, hprev + (size_t)(a.r0 + rc0) * H, H, nr, H);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * C; idx += kThreads) {
        const int r = idx / C, col = idx % C;
        zb[(rc0 + r) * C + col] = dot(hs + (size_t)r * S, ws + (size_t)col * S, H);
      }
      __syncthreads();
    }

    for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
      const int r = idx / U, u = idx % U, j = j0 + u;
      if (j >= H) continue;
      const size_t tb = (size_t)t * B + a.r0 + r;
      const T* zrow = zx + tb * 3 * H;
      const float* zr = zb + r * C;
      const float rg = sigmoid(to_f(zrow[j]) + zr[u]);
      const float ug = sigmoid(to_f(zrow[H + j]) + zr[U + u]);
      const float zh_n = zr[2 * U + u];
      const float ng = tanhf(to_f(zrow[2 * H + j]) + rg * zh_n);
      const float hn = (1.0f - ug) * ng + ug * hown[idx];
      hown[idx] = hn;
      ys[tb * H + j] = from_f<T>(hn);
      if (SAVE) {  // the backward's residuals, in T
        T* g = gs + (size_t)idx * 4;
        g[0] = from_f<T>(rg);
        g[1] = from_f<T>(ug);
        g[2] = from_f<T>(ng);
        g[3] = from_f<T>(zh_n);
      }
      if (t == a.T - 1) hT[(size_t)(a.r0 + r) * H + j] = from_f<T>(hn);
    }
    // every block's ys[t] must be written before any block stages it
    if (t + 1 < a.T) grid.sync();
  }
  if (SAVE) flush(a.T - 1);
}

template <typename T, bool SAVE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto smem = [&](int units, int chunk) {
    return smem_bytes<T>(a.H, a.rows, units, chunk, SAVE);
  };
  return launch_cooperative(gru_fwd_kernel<T, SAVE>, a, smem, sizeof(T) * row_stride<T>(a.H),
                            stream);
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  return a.gates ? launch<T, true>(a, s) : launch<T, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. gates and zhn are both null (the
// inference instance) or both set (the training instance, which also saves
// the backward's residuals). Handles batch rows [r0, r0 + rows) of the
// (T, B, .) tensors. Returns the cudaError_t of the launch (0 on success).
extern "C" int dl4j_gru_fwd(int dtype, const void* zx, const void* w_rec, const void* h0,
                            void* ys, void* hT, void* gates, void* zhn, int T, int B, int H,
                            int r0, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1 || rows < 1 || r0 < 0 || r0 + rows > B ||
      (gates == nullptr) != (zhn == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{zx, w_rec, h0, ys, hT, gates, zhn, T, B, H, r0, rows, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
