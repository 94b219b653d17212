// Persistent GRU backward recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas/fused_gru.py,
// _gru_bwd_kernel_call (pallas_call at :224, kernel _bwd_kernel :170): the
// reset-after cell's reverse-time recurrence. T is the storage type (float or
// bf16).
//
// Function, in reverse time from dh = dhT (fp32), for t = T-1 .. 0, reading
// the forward's residuals: the activated gates [r, u, n] and zh_n at t, both
// in T, and h_prev = ys[t-1] (h0 at t = 0), already rounded to T:
//   dh   += dys_t
//   du    = dh * (h_prev - n) * u * (1 - u)
//   da    = dh * (1 - u) * (1 - n^2)            (pre-tanh gradient of n)
//   ds_r  = da * zh_n * r * (1 - r)
//   dzx_t = round_T([ds_r, du, da])             (written out)
//   dh    = dh * u + round_T(ds_r) @ W_r^T + round_T(du) @ W_u^T
//                  + round_T(da * r) @ W_n^T    (products of T values, fp32 sum)
// and at the end dh0 = round_T(dh). The n-third of the recurrent operand is
// round_T(da * r) with da unrounded, which is not dzx_n * r in bf16, so the
// kernel writes it to a scratch of its own. dW_rec = h_prev^T @ ds_rec is a
// large product outside the kernel, as in the JAX package.
//
// Bound at the char-RNN training shape (B=64, T=256, H=512, bf16), per layer:
// the recurrent product is 2*T*B*3H*H = 25.8 GFLOP, 26 us at 989 TFLOP/s;
// dys + gates + zh_n + h_prev + W_rec + dzx = 153 MB, 46 us at 3.35 TB/s. As
// in the forward, neither sets the pace: 256 dependent steps, each ending in
// a grid-wide barrier.
//
// Design, the mirror of the forward's and lstm_bwd.cu's: one cooperative
// launch per layer per sequence (per group of at most `rows` batch rows).
// Block b owns hidden units [b*U, b*U+U), pins the rows W_rec[j, :] of its
// units (U x 3H; 12 KB at U=4, H=512, bf16) in shared memory, and keeps its
// units' fp32 dh carry there. At step t it computes its units' three dzx
// columns for every row, writes them to dzx[t] and round_T(da * r) to the
// scratch, keeps dh * u, and meets the grid barrier. Then it stages the
// step's recurrent operand of every row, [dzx[t][:2H], scratch], from L2 in
// row chunks with 16-byte loads, and computes its units' dh for step t-1 on
// the CUDA cores. The scratch is a (2, B, H) ping-pong: a block writes step
// t-1's third only after the barrier that ends every block's reads of step
// t+1's, which used the other half. Tensor cores, TMA and clusters are left
// for later work.
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
  const void* gates;  // (T, B, 3H) activated [r, u, n] (forward residual)
  const void* zhn;    // (T, B, H) recurrent n pre-activation (forward residual)
  const void* ys;     // (T, B, H) forward output: h_prev of step t is ys[t-1]
  const void* h0;     // (B, H)
  const void* w;      // (H, 3H)
  void* dzx;          // (T, B, 3H) input-projection gradient
  void* dh0;          // (B, H)
  void* scratch;      // (2, B, H) round_T(da * r), ping-pong by step parity
  int T, B, H;
  int r0, rows;       // batch rows [r0, r0 + rows) handled by this launch
  int units;          // hidden units per block
  int chunk;          // rows of the recurrent operand staged at once
};

template <typename T>
size_t smem_bytes(int H, int rows, int units, int chunk) {
  return sizeof(float) * (size_t)rows * units +
         sizeof(T) * ((size_t)units + chunk) * row_stride<T>(3 * H);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gru_bwd_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.units, H = a.H, R = a.rows, RC = a.chunk, B = a.B;
  const int S = row_stride<T>(3 * H);
  float* dhc = reinterpret_cast<float*>(smem);            // (R, U) fp32 dh carry
  T* ws = reinterpret_cast<T*>(dhc + (size_t)R * U);      // (U, S) rows of W_rec
  T* dss = ws + (size_t)U * S;                            // (RC, S) staged operand

  const T* dys = static_cast<const T*>(a.dys);
  const T* gates = static_cast<const T*>(a.gates);
  const T* zhn = static_cast<const T*>(a.zhn);
  const T* ys = static_cast<const T*>(a.ys);
  const T* h0 = static_cast<const T*>(a.h0);
  const T* w = static_cast<const T*>(a.w);
  T* dzx = static_cast<T*>(a.dzx);
  T* scratch = static_cast<T*>(a.scratch);
  const int j0 = blockIdx.x * U;

  // Pin this block's rows: ws[u, k] = W_rec[j0 + u, k].
  for (int idx = threadIdx.x; idx < U * 3 * H; idx += kThreads) {
    const int u = idx / (3 * H), k = idx % (3 * H), j = j0 + u;
    ws[(size_t)u * S + k] = j < H ? w[(size_t)j * 3 * H + k] : from_f<T>(0.0f);
  }
  for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
    const int r = idx / U, j = j0 + idx % U;
    dhc[idx] = j < H ? to_f(static_cast<const T*>(a.dhT)[(size_t)(a.r0 + r) * H + j]) : 0.0f;
  }
  __syncthreads();

  for (int t = a.T - 1; t >= 0; --t) {
    T* nthird = scratch + (size_t)(t & 1) * B * H;
    // dzx[t] and round_T(da * r) for this block's units; dh * u stays in dhc
    for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
      const int r = idx / U, j = j0 + idx % U;
      if (j >= H) continue;
      const int b = a.r0 + r;
      const size_t tb = (size_t)t * B + b;
      const T* gr = gates + tb * 3 * H;
      const float rg = to_f(gr[j]), ug = to_f(gr[H + j]), ng = to_f(gr[2 * H + j]);
      const float hp = t == 0 ? to_f(h0[(size_t)b * H + j]) : to_f(ys[(tb - B) * H + j]);
      const float dh = dhc[idx] + to_f(dys[tb * H + j]);
      const float du = dh * (hp - ng) * ug * (1.0f - ug);
      const float da = dh * (1.0f - ug) * (1.0f - ng * ng);
      const float ds_r = da * to_f(zhn[tb * H + j]) * rg * (1.0f - rg);
      T* dr = dzx + tb * 3 * H;
      dr[j] = from_f<T>(ds_r);
      dr[H + j] = from_f<T>(du);
      dr[2 * H + j] = from_f<T>(da);
      nthird[(size_t)b * H + j] = from_f<T>(da * rg);
      dhc[idx] = dh * ug;
    }
    // every block's dzx[t] and n-third must be written before any block
    // stages them
    grid.sync();

    // dh for step t-1: this block's units of [dzx_r, dzx_u, da*r] @ W_rec^T
    for (int rc0 = 0; rc0 < R; rc0 += RC) {
      const int nr = min(RC, R - rc0);
      const size_t row0 = (size_t)a.r0 + rc0;
      stage_rows(dss, S, dzx + ((size_t)t * B + row0) * 3 * H, 3 * H, nr, 2 * H);
      stage_rows(dss + 2 * H, S, nthird + row0 * H, H, nr, H);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * U; idx += kThreads) {
        const int r = idx / U, u = idx % U;
        const int o = (rc0 + r) * U + u;
        dhc[o] = dhc[o] + dot(dss + (size_t)r * S, ws + (size_t)u * S, 3 * H);
      }
      __syncthreads();
    }
  }

  for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
    const int r = idx / U, j = j0 + idx % U;
    if (j >= H) continue;
    static_cast<T*>(a.dh0)[(size_t)(a.r0 + r) * H + j] = from_f<T>(dhc[idx]);
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto smem = [&](int units, int chunk) { return smem_bytes<T>(a.H, a.rows, units, chunk); };
  return launch_cooperative(gru_bwd_kernel<T>, a, smem, sizeof(T) * row_stride<T>(3 * a.H),
                            stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scratch is (2, B, H) of the same dtype,
// written and read by the kernel only. Handles batch rows [r0, r0 + rows) of
// the (T, B, .) tensors. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int dl4j_gru_bwd(int dtype, const void* dys, const void* dhT, const void* gates,
                            const void* zhn, const void* ys, const void* h0, const void* w_rec,
                            void* dzx, void* dh0, void* scratch, int T, int B, int H, int r0,
                            int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1 || rows < 1 || r0 < 0 || r0 + rows > B)
    return (int)cudaErrorInvalidValue;
  Args a{dys, dhT, gates, zhn, ys, h0, w_rec, dzx, dh0, scratch, T, B, H, r0, rows, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
