// Persistent LSTM forward recurrence for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   - deeplearning4j_tpu/ops/pallas/fused_lstm.py, _lstm_fwd (pallas_call at
//     :162, kernel _fwd_kernel :91): plain cell, no peepholes, no mask;
//   - deeplearning4j_tpu/ops/pallas/fused_lstm_graves.py, _graves_fwd
//     (pallas_call at :146, kernel _fwd_kernel :73): peephole cell with a
//     per-step mask (masked steps hold h/c and emit the held h).
// One template serves both: PEEP and MASK switch the peephole terms and the
// mask blend on or off, and T is the storage type (float or bf16). SAVE
// (training) also writes the residuals the backward kernel (lstm_bwd.cu)
// reads, as the Pallas kernels do with save_residuals=True: the activated
// gates (T, B, 4H) and the carried cell sequence c' (T, B, H), both in T.
//
// Function (gate order [i, f, g, o], peepholes [p_i, p_f, p_o]):
//   z   = zx_t + round_T(h) @ W_rec        (products of T values, fp32 sum)
//   i   = sigmoid(z_i + c * p_i)   f = sigmoid(z_f + c * p_f)   g = tanh(z_g)
//   c~  = f * c + i * g            o = sigmoid(z_o + c~ * p_o)  h~ = o * tanh(c~)
//   h'  = m * h~ + (1 - m) * h     c' = m * c~ + (1 - m) * c
// h and c are carried in fp32; ys, hT and cT are stored in T. The product
// reads h rounded to T, which is exactly what ys[t-1] holds (or h0 at t=0).
//
// Bound at the char-RNN serving shape (B=64, T=256, H=512, bf16), per layer:
// 2*T*B*H*4H = 34.4 GFLOP, 35 us at 989 TFLOP/s; zx + ys + W_rec = 86 MB,
// 26 us at 3.35 TB/s. Neither is what sets the pace: the 256 steps depend on
// each other, and every step ends in a grid-wide barrier.
//
// Design: one cooperative launch per layer per sequence (per group of at most
// `rows` batch rows). Block b owns hidden units [b*U, b*U+U) and pins the 4U
// gate columns of W_rec it needs in shared memory for all T steps (the
// counterpart of "W_rec pinned in VMEM": at H=512 bf16 the matrix is 2 MB and
// cannot sit in one SM, but its 4-unit slices are 16 KB). Its units' fp32 h
// and c stay in shared memory. At step t the block stages h_{t-1} of every
// row from ys[t-1] (L2, written by all blocks) in shared memory, computes its
// 4U gate pre-activations for every row on the CUDA cores, applies the cell,
// writes its units of ys[t], and waits at the grid barrier. Tensor cores,
// TMA and clusters are left for later work.
//
// Limits: a shape whose W_rec slices cannot all be resident at once (with
// 64 rows per launch on an H100's 132 SMs: H > 1848 in bf16, H > 1320 in
// fp32) is refused with cudaErrorInvalidConfiguration, and the wrapper
// raises.

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace dl4j_lstm;

namespace {

struct Args {
  const void* zx;    // (T, B, 4H)
  const void* w;     // (H, 4H)
  const void* peep;  // (3H,) or null
  const void* h0;    // (B, H)
  const void* c0;    // (B, H)
  const void* mask;  // (T, B) or null
  void* ys;          // (T, B, H)
  void* hT;          // (B, H)
  void* cT;          // (B, H)
  void* gates;       // (T, B, 4H) activated [i, f, g, o], or null: SAVE only
  void* cseq;        // (T, B, H) carried cell, or null: SAVE only
  int T, B, H;
  int r0, rows;      // batch rows [r0, r0 + rows) handled by this launch
  int units;         // hidden units per block
  int chunk;         // rows of h staged in shared memory at once
};

template <typename T>
size_t smem_bytes(int H, int rows, int units, int chunk, bool save) {
  const int C = 4 * units;
  return sizeof(float) * ((size_t)rows * C + 2 * (size_t)rows * units) +
         sizeof(T) * ((save ? (size_t)rows * C : 0) + (size_t)H * C + (size_t)chunk * H);
}

template <typename T, bool PEEP, bool MASK, bool SAVE>
__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.units, C = 4 * U, H = a.H, R = a.rows, RC = a.chunk;
  const int B = a.B;
  float* zb = reinterpret_cast<float*>(smem);  // (R, C) recurrent products
  float* hown = zb + (size_t)R * C;            // (R, U) fp32 h carry
  float* cown = hown + (size_t)R * U;          // (R, U) fp32 c carry
  T* gs = reinterpret_cast<T*>(cown + (size_t)R * U);  // (R*U, 4) gates, SAVE only
  T* ws = gs + (SAVE ? (size_t)R * C : 0);             // (H, C) W_rec slice
  T* hs = ws + (size_t)H * C;                          // (RC, H) staged h

  const T* zx = static_cast<const T*>(a.zx);
  const T* w = static_cast<const T*>(a.w);
  const T* peep = static_cast<const T*>(a.peep);
  const T* h0 = static_cast<const T*>(a.h0);
  const T* c0 = static_cast<const T*>(a.c0);
  const T* mask = static_cast<const T*>(a.mask);
  T* ys = static_cast<T*>(a.ys);
  T* hT = static_cast<T*>(a.hT);
  T* cT = static_cast<T*>(a.cT);
  T* gates = static_cast<T*>(a.gates);
  T* cseq = static_cast<T*>(a.cseq);
  const int j0 = blockIdx.x * U;

  // Pin this block's gate columns: ws[k, g*U + u] = W_rec[k, g*H + j0 + u].
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int k = idx / C, col = idx % C, g = col / U, j = j0 + col % U;
    ws[idx] = j < H ? w[(size_t)k * 4 * H + (size_t)g * H + j] : from_f<T>(0.0f);
  }
  for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
    const int r = idx / U, j = j0 + idx % U;
    const size_t o = (size_t)(a.r0 + r) * H + j;
    hown[idx] = j < H ? to_f(h0[o]) : 0.0f;
    cown[idx] = j < H ? to_f(c0[o]) : 0.0f;
  }
  __syncthreads();

  // SAVE: write step ts's gates, kept in gs since before its barrier. Issued
  // after the barrier, the stores drain while the next step computes instead
  // of holding up the barrier's fence (written before it, they added ~60% to
  // the launch). Each thread writes back what it put in gs.
  auto flush_gates = [&](int ts) {
    for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
      const int j = j0 + idx % U;
      if (j >= H) continue;
      T* gr = gates + ((size_t)ts * B + a.r0 + idx / U) * 4 * H;
      const T* g = gs + (size_t)idx * 4;
      gr[j] = g[0];
      gr[H + j] = g[1];
      gr[2 * H + j] = g[2];
      gr[3 * H + j] = g[3];
    }
  };

  for (int t = 0; t < a.T; ++t) {
    if (SAVE && t > 0) flush_gates(t - 1);
    const T* hprev = t == 0 ? h0 : ys + (size_t)(t - 1) * B * H;
    for (int rc0 = 0; rc0 < R; rc0 += RC) {
      const int nr = min(RC, R - rc0);
      for (int idx = threadIdx.x; idx < nr * H; idx += kThreads) {
        const int r = idx / H, k = idx % H;
        hs[idx] = load_l2(hprev + (size_t)(a.r0 + rc0 + r) * H + k);
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * C; idx += kThreads) {
        const int r = idx / C, col = idx % C;
        const T* hr = hs + (size_t)r * H;
        float acc = 0.0f;
        for (int k = 0; k < H; ++k) acc = fmaf(to_f(hr[k]), to_f(ws[k * C + col]), acc);
        zb[(rc0 + r) * C + col] = acc;
      }
      __syncthreads();
    }

    for (int idx = threadIdx.x; idx < R * U; idx += kThreads) {
      const int r = idx / U, u = idx % U, j = j0 + u;
      if (j >= H) continue;
      const int b = a.r0 + r;
      const T* zrow = zx + ((size_t)t * B + b) * 4 * H;
      const float* zr = zb + r * C;
      const float c = cown[idx], h = hown[idx];
      float zi = to_f(zrow[j]) + zr[u];
      float zf = to_f(zrow[H + j]) + zr[U + u];
      const float zg = to_f(zrow[2 * H + j]) + zr[2 * U + u];
      float zo = to_f(zrow[3 * H + j]) + zr[3 * U + u];
      if (PEEP) {
        zi += c * to_f(peep[j]);
        zf += c * to_f(peep[H + j]);
      }
      const float ig = sigmoid(zi), fg = sigmoid(zf), gg = tanhf(zg);
      float cn = fg * c + ig * gg;
      if (PEEP) zo += cn * to_f(peep[2 * H + j]);
      const float og = sigmoid(zo);
      float hn = og * tanhf(cn);
      if (MASK) {
        const float m = to_f(mask[(size_t)t * B + b]);
        hn = m * hn + (1.0f - m) * h;
        cn = m * cn + (1.0f - m) * c;
      }
      hown[idx] = hn;
      cown[idx] = cn;
      ys[((size_t)t * B + b) * H + j] = from_f<T>(hn);
      if (SAVE) {  // the backward's residuals, in T
        T* g = gs + (size_t)idx * 4;
        g[0] = from_f<T>(ig);
        g[1] = from_f<T>(fg);
        g[2] = from_f<T>(gg);
        g[3] = from_f<T>(og);
        cseq[((size_t)t * B + b) * H + j] = from_f<T>(cn);
      }
      if (t == a.T - 1) {
        hT[(size_t)b * H + j] = from_f<T>(hn);
        cT[(size_t)b * H + j] = from_f<T>(cn);
      }
    }
    // every block's ys[t] must be written before any block stages it
    if (t + 1 < a.T) grid.sync();
  }
  if (SAVE) flush_gates(a.T - 1);
}

template <typename T, bool PEEP, bool MASK, bool SAVE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto smem = [&](int units, int chunk) {
    return smem_bytes<T>(a.H, a.rows, units, chunk, SAVE);
  };
  return launch_cooperative(lstm_fwd_kernel<T, PEEP, MASK, SAVE>, a, smem,
                            sizeof(T) * a.H, stream);
}

template <typename T, bool SAVE>
cudaError_t dispatch_cell(const Args& a, cudaStream_t s) {
  if (a.peep && a.mask) return launch<T, true, true, SAVE>(a, s);
  if (a.peep) return launch<T, true, false, SAVE>(a, s);
  if (a.mask) return launch<T, false, true, SAVE>(a, s);
  return launch<T, false, false, SAVE>(a, s);
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  return a.gates ? dispatch_cell<T, true>(a, s) : dispatch_cell<T, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. peep and mask may be null. gates and
// cseq are both null (the inference instance) or both set (the training
// instance, which also saves the backward's residuals). Handles batch rows
// [r0, r0 + rows) of the (T, B, .) tensors. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dl4j_lstm_fwd(int dtype, const void* zx, const void* w_rec, const void* peep,
                             const void* h0, const void* c0, const void* mask, void* ys,
                             void* hT, void* cT, void* gates, void* cseq, int T, int B,
                             int H, int r0, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1 || rows < 1 || r0 < 0 || r0 + rows > B ||
      (gates == nullptr) != (cseq == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{zx, w_rec, peep, h0, c0, mask, ys, hT, cT, gates, cseq, T, B, H, r0, rows, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
