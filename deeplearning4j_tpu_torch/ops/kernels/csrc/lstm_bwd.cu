// Persistent LSTM backward recurrence for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   - deeplearning4j_tpu/ops/pallas/fused_lstm.py, _lstm_bwd_kernel_call
//     (pallas_call at :242, kernel _bwd_kernel :189): plain cell;
//   - deeplearning4j_tpu/ops/pallas/fused_lstm_graves.py,
//     _graves_bwd_kernel_call (pallas_call at :241, kernel _bwd_kernel :179):
//     peephole cell with a per-step mask.
// One template serves both, as the forward's does (lstm_fwd.cu): PEEP and
// MASK switch the peephole terms and the mask pass-through, T is the storage
// type (float or bf16).
//
// Function, in reverse time from dh = dhT, dc = dcT (both fp32), for
// t = T-1 .. 0, reading the forward's residuals: the activated gates
// [i, f, g, o] at t and c_{t-1} (c0 at t = 0, else the saved carried cell
// cseq[t-1]), both in T:
//   c~  = f * c_{t-1} + i * g          (rebuilt, as the TPU kernel does)
//   dh_ = dh + dys_t                   dh~ = m * dh_      dc~ = m * dc
//   do  = dh~ * tanh(c~) * o * (1 - o)
//   dc~ = dc~ + dh~ * o * (1 - tanh(c~)^2) + do * p_o
//   di  = dc~ * g * i * (1 - i)   df = dc~ * c_{t-1} * f * (1 - f)
//   dg  = dc~ * i * (1 - g^2)
//   ds_t = round_T([di, df, dg, do])   (written out: it is dzx, and feeds dW_rec)
//   dh  = ds_t @ W_rec^T + (1 - m) * dh_     (products of T values, fp32 sum)
//   dc  = dc~ * f + di * p_i + df * p_f + (1 - m) * dc
// and at the end dh0 = round_T(dh), dc0 = round_T(dc). dW_rec = h_prev^T @ ds
// and the peephole gradients are large reductions outside the kernel, as in
// the JAX package.
//
// Bound at the char-RNN training shape (B=64, T=256, H=512, bf16), per layer:
// the recurrent product is 2*T*B*4H*H = 34.4 GFLOP, 35 us at 989 TFLOP/s;
// dys + gates + cseq + ds + W_rec = 170 MB, 51 us at 3.35 TB/s. As in the
// forward, neither sets the pace: 256 dependent steps, each ending in a
// grid-wide barrier.
//
// Design, the mirror of the forward's: one cooperative launch per layer per
// sequence (per group of at most `rows` batch rows). Block b owns hidden units
// [b*U, b*U+U) and pins the rows W_rec[j, :] of its units (U x 4H; 16 KB at
// U=4, H=512, bf16) in shared memory, with its units' fp32 dh/dc carries. At
// step t it computes its units' four ds columns for every row and writes them
// to ds[t], meets the grid barrier, stages ds[t] of every row from L2 in row
// chunks (rows are 4H wide, four times the forward's, so the chunks are
// smaller), and computes its units' dh for step t-1 on the CUDA cores. The
// staging copies 16 bytes per load with four loads in flight per thread: one
// small load at a time left each step waiting out hundreds of L2 round trips.
// Staged rows are padded by one 4-byte word so that the rows a warp reads at
// once fall in different shared-memory banks, and the product reads bf16
// values in pairs. Tensor cores, TMA and clusters are left for later work.
//
// Limits: a shape whose W_rec rows cannot all be resident at once is refused
// with cudaErrorInvalidConfiguration, and the wrapper raises.

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace dl4j_lstm;

namespace {

struct Args {
  const void* dys;    // (T, B, H) cotangent of ys
  const void* dhT;    // (B, H)
  const void* dcT;    // (B, H)
  const void* gates;  // (T, B, 4H) activated [i, f, g, o] (forward residual)
  const void* cseq;   // (T, B, H) carried cell (forward residual)
  const void* c0;     // (B, H)
  const void* w;      // (H, 4H)
  const void* peep;   // (3H,) or null
  const void* mask;   // (T, B) or null
  void* ds;           // (T, B, 4H) pre-activation gradients
  void* dh0;          // (B, H)
  void* dc0;          // (B, H)
  int T, B, H;
  int r0, rows;       // batch rows [r0, r0 + rows) handled by this launch
  int units;          // hidden units per block
  int chunk;          // rows of ds staged in shared memory at once
};

template <typename T>
size_t smem_bytes(int H, int rows, int units, int chunk) {
  return sizeof(float) * 3 * (size_t)rows * units +
         sizeof(T) * ((size_t)units + chunk) * row_stride<T>(4 * H);
}

template <typename T, bool PEEP, bool MASK>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.units, H = a.H, R = a.rows, RC = a.chunk, B = a.B;
  const int S = row_stride<T>(4 * H);  // 4H values plus one 4-byte word
  float* dhc = reinterpret_cast<float*>(smem);  // (R, U) fp32 dh carry
  float* dcc = dhc + (size_t)R * U;             // (R, U) fp32 dc carry
  float* pass = dcc + (size_t)R * U;            // (R, U) (1 - m) * dh_ (MASK)
  T* ws = reinterpret_cast<T*>(pass + (size_t)R * U);  // (U, S) rows of W_rec
  T* dss = ws + (size_t)U * S;                          // (RC, S) staged ds

  const T* dys = static_cast<const T*>(a.dys);
  const T* gates = static_cast<const T*>(a.gates);
  const T* cseq = static_cast<const T*>(a.cseq);
  const T* c0 = static_cast<const T*>(a.c0);
  const T* w = static_cast<const T*>(a.w);
  const T* peep = static_cast<const T*>(a.peep);
  const T* mask = static_cast<const T*>(a.mask);
  T* ds = static_cast<T*>(a.ds);
  const int j0 = blockIdx.x * U;

  // Pin this block's rows: ws[u, k] = W_rec[j0 + u, k].
  for (int idx = threadIdx.x; idx < U * 4 * H; idx += kThreads) {
    const int u = idx / (4 * H), k = idx % (4 * H), j = j0 + u;
    ws[(size_t)u * S + k] = j < H ? w[(size_t)j * 4 * H + k] : from_f<T>(0.0f);
  }
  for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
    const int r = idx / U, j = j0 + idx % U;
    const size_t o = (size_t)(a.r0 + r) * H + j;
    dhc[idx] = j < H ? to_f(static_cast<const T*>(a.dhT)[o]) : 0.0f;
    dcc[idx] = j < H ? to_f(static_cast<const T*>(a.dcT)[o]) : 0.0f;
    pass[idx] = 0.0f;
  }
  __syncthreads();

  for (int t = a.T - 1; t >= 0; --t) {
    // ds[t] for this block's units, and every carry term but the product
    for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
      const int r = idx / U, j = j0 + idx % U;
      if (j >= H) continue;
      const int b = a.r0 + r;
      const size_t tb = (size_t)t * B + b;
      const T* gr = gates + tb * 4 * H;
      const float ig = to_f(gr[j]), fg = to_f(gr[H + j]);
      const float gg = to_f(gr[2 * H + j]), og = to_f(gr[3 * H + j]);
      const float cp = t == 0 ? to_f(c0[(size_t)b * H + j]) : to_f(cseq[(tb - B) * H + j]);
      const float tc = tanhf(fg * cp + ig * gg);
      const float dh_tot = dhc[idx] + to_f(dys[tb * H + j]);
      const float dc_tot = dcc[idx];
      const float m = MASK ? to_f(mask[tb]) : 1.0f;
      const float dh_til = MASK ? m * dh_tot : dh_tot;
      float dc_til = MASK ? m * dc_tot : dc_tot;
      const float d_o = dh_til * tc * og * (1.0f - og);
      dc_til = dc_til + dh_til * og * (1.0f - tc * tc);
      if (PEEP) dc_til += d_o * to_f(peep[2 * H + j]);
      const float di = dc_til * gg * ig * (1.0f - ig);
      const float df = dc_til * cp * fg * (1.0f - fg);
      const float dg = dc_til * ig * (1.0f - gg * gg);
      T* dr = ds + tb * 4 * H;
      dr[j] = from_f<T>(di);
      dr[H + j] = from_f<T>(df);
      dr[2 * H + j] = from_f<T>(dg);
      dr[3 * H + j] = from_f<T>(d_o);
      float dc_new = dc_til * fg;
      if (PEEP) {  // in the JAX kernel's order: ((dc~ f + di p_i) + df p_f) + ...
        dc_new += di * to_f(peep[j]);
        dc_new += df * to_f(peep[H + j]);
      }
      if (MASK) {
        dc_new += (1.0f - m) * dc_tot;
        pass[idx] = (1.0f - m) * dh_tot;
      }
      dcc[idx] = dc_new;
    }
    // every block's ds[t] must be written before any block stages it
    grid.sync();

    // dh for step t-1: this block's units of round_T(ds[t]) @ W_rec^T
    for (int rc0 = 0; rc0 < R; rc0 += RC) {
      const int nr = min(RC, R - rc0);
      stage_rows(dss, S, ds + ((size_t)t * B + a.r0 + rc0) * 4 * H, 4 * H, nr, 4 * H);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * U; idx += kThreads) {
        const int r = idx / U, u = idx % U;
        const float acc = dot(dss + (size_t)r * S, ws + (size_t)u * S, 4 * H);
        const int o = (rc0 + r) * U + u;
        dhc[o] = MASK ? acc + pass[o] : acc;
      }
      __syncthreads();
    }
  }

  for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
    const int r = idx / U, j = j0 + idx % U;
    if (j >= H) continue;
    const size_t o = (size_t)(a.r0 + r) * H + j;
    static_cast<T*>(a.dh0)[o] = from_f<T>(dhc[idx]);
    static_cast<T*>(a.dc0)[o] = from_f<T>(dcc[idx]);
  }
}

template <typename T, bool PEEP, bool MASK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto smem = [&](int units, int chunk) { return smem_bytes<T>(a.H, a.rows, units, chunk); };
  return launch_cooperative(lstm_bwd_kernel<T, PEEP, MASK>, a, smem,
                            sizeof(T) * row_stride<T>(4 * a.H), stream);
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.peep && a.mask) return launch<T, true, true>(a, s);
  if (a.peep) return launch<T, true, false>(a, s);
  if (a.mask) return launch<T, false, true>(a, s);
  return launch<T, false, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. peep and mask may be null. Handles batch
// rows [r0, r0 + rows) of the (T, B, .) tensors. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int dl4j_lstm_bwd(int dtype, const void* dys, const void* dhT, const void* dcT,
                             const void* gates, const void* cseq, const void* c0,
                             const void* w_rec, const void* peep, const void* mask, void* ds,
                             void* dh0, void* dc0, int T, int B, int H, int r0, int rows,
                             void* stream) {
  if (T < 1 || B < 1 || H < 1 || rows < 1 || r0 < 0 || r0 + rows > B)
    return (int)cudaErrorInvalidValue;
  Args a{dys, dhT, dcT, gates, cseq, c0, w_rec, peep, mask, ds, dh0, dc0,
         T, B, H, r0, rows, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
