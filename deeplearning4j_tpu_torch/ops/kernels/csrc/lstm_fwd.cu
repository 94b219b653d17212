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
// each other, and every step ends in a barrier.
//
// Two designs, one cooperative launch per layer per sequence (per group of
// at most `rows` batch rows) each; the C entry point picks one.
//
// bf16 with H % 8 == 0 and 16-byte aligned operands: the row-group kernel,
// lstm_fwd_mma_kernel<PEEP, MASK, SAVE>. A block owns a row group of up to
// 16 batch rows (one mma M tile) and U hidden units (4, 8 or 16; U = 16 at
// B=64, H=512: 4 row groups x 32 unit groups = 128 blocks). It pins the 4U
// gate columns of W_rec it needs, transposed (4U x H bf16, 64 KB at U=16),
// in shared memory; each of its cells (row, unit) belongs to one thread,
// which carries h and c in registers. At step t the block stages its 16 rows
// of h_{t-1} (16 KB) from ys[t-1] by 16-byte cp.async.cg (through L2: other
// blocks wrote them), forms the 16 x 4U recurrent products on the tensor
// cores (mma.sync m16n8k16, bf16 operands, fp32 sums; K split over the 8
// warps, whose partial products are summed in shared memory in warp order,
// so a second launch gives the same bits), applies the cell, writes its
// units of ys[t], and meets the other blocks of its row group at a counter
// barrier (lstm_common.cuh): rows never interact, so it waits for no other
// group. zx[t+1] (and the mask) of its cells is loaded before the wait,
// off the critical path; the saving instance's gates are stored between
// arrival and wait, where nobody waits for them. L2 reads per step: 16 KB a
// block, 2 MB at the main path's shape (8 MB with every block staging
// every row).
//
// float32, and bf16 that the row-group kernel does not take (H % 8 != 0, an
// unaligned operand, or no plan that fits, as at H = 1024 with 64 rows): the
// CUDA-core kernel, lstm_fwd_kernel<T, PEEP, MASK, SAVE>. Block b owns
// hidden units [b*U, b*U+U) of every row and pins the 4U gate columns of
// W_rec it needs in shared memory; its units' fp32 h and c stay in shared
// memory. At step t it stages h_{t-1} of every row from ys[t-1] with 16-byte
// loads where rows allow them (stage_rows), computes its 4U gate
// pre-activations for every row on the CUDA cores, applies the cell, writes
// its units of ys[t], and waits at the grid barrier.
//
// Limits: a shape that neither design can keep resident (with 64 rows per
// launch on an H100's 132 SMs: H > 1848 in bf16, H > 1320 in fp32) is
// refused with cudaErrorInvalidConfiguration, and the wrapper raises.

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace dl4j_lstm;
using attn_mma::bf16;

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
  int* counters;     // (B,) zeroed: the row group from batch row b counts at counters[b]
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
      stage_rows(hs, H, hprev + (size_t)(a.r0 + rc0) * H, H, nr, H);
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

// Shared memory of the row-group kernel: W_rec's 4U gate columns as rows
// (4U x LD bf16), the staged h rows (16 x LD bf16), and the 8 warps' partial
// products (8 x 16 x (4U + 8) fp32). LD = H rounded up to 16, plus 8: an odd
// number of 16-byte words, so the rows an ldmatrix reads fall in different
// banks.
__host__ __device__ inline int mma_ld(int H) { return attn_mma::tile_ld(attn_mma::round16(H)); }

inline size_t mma_smem_bytes(int H, int units) {
  const int nc = 4 * units;
  return sizeof(bf16) * (size_t)(nc + kGroupRows) * mma_ld(H) +
         sizeof(float) * (size_t)(kThreads / 32) * kGroupRows * (nc + 8);
}

template <bool PEEP, bool MASK, bool SAVE>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kWarps = kThreads / 32;
  const int U = a.units, NC = 4 * U, PS = NC + 8, H = a.H, B = a.B;
  const int KP = attn_mma::round16(H), LD = mma_ld(H);
  const int ugroups = (H + U - 1) / U;
  const int rg = blockIdx.x / ugroups, j0 = (blockIdx.x % ugroups) * U;
  const int b0 = a.r0 + rg * kGroupRows;
  const int nr = min(kGroupRows, a.r0 + a.rows - b0);
  bf16* wt = reinterpret_cast<bf16*>(smem);      // (NC, LD): column g*U + u of W_rec's slice
  bf16* hs = wt + (size_t)NC * LD;               // (16, LD): staged h_{t-1}
  float* part = reinterpret_cast<float*>(hs + (size_t)kGroupRows * LD);  // (8, 16, PS)
  int* counter = a.counters + b0;

  const bf16* zx = static_cast<const bf16*>(a.zx);
  const bf16* w = static_cast<const bf16*>(a.w);
  const bf16* peep = static_cast<const bf16*>(a.peep);
  const bf16* h0 = static_cast<const bf16*>(a.h0);
  const bf16* mask = static_cast<const bf16*>(a.mask);
  bf16* ys = static_cast<bf16*>(a.ys);
  bf16* gates = static_cast<bf16*>(a.gates);
  bf16* cseq = static_cast<bf16*>(a.cseq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Pin: wt[g*U + u][k] = W_rec[k, g*H + j0 + u], zero past H (k or j).
  for (int idx = tid; idx < KP * NC; idx += kThreads) {
    const int k = idx / NC, n = idx % NC, j = j0 + n % U;
    wt[(size_t)n * LD + k] = k < H && j < H ? w[(size_t)k * 4 * H + (size_t)(n / U) * H + j]
                                            : __float2bfloat16(0.0f);
  }

  // This thread's cell: row r of the group, unit u of the block.
  const int r = tid / U, u = tid % U, b = b0 + r, j = j0 + u;
  const bool cell = tid < kGroupRows * U && r < nr && j < H;
  float h = 0.0f, c = 0.0f, p_i = 0.0f, p_f = 0.0f, p_o = 0.0f, m = 1.0f, zn[4] = {};
  if (cell) {
    h = __bfloat162float(h0[(size_t)b * H + j]);
    c = __bfloat162float(static_cast<const bf16*>(a.c0)[(size_t)b * H + j]);
    if (PEEP) {
      p_i = __bfloat162float(peep[j]);
      p_f = __bfloat162float(peep[H + j]);
      p_o = __bfloat162float(peep[2 * H + j]);
    }
    const bf16* zrow = zx + (size_t)b * 4 * H;
#pragma unroll
    for (int g = 0; g < 4; ++g) zn[g] = __bfloat162float(zrow[g * H + j]);
    if (MASK) m = __bfloat162float(mask[b]);
  }
  float gv[4] = {};  // SAVE: this step's activated gates, stored after arrival

  // ldmatrix row addresses: A = h rows (0-7 | 8-15) x (k 0-7 | 8-15); B = W
  // columns n 0-7 (k 0-7 | 8-15), then n 8-15 (k 0-7 | 8-15)
  const bf16* ha = hs + (lane & 15) * LD + (lane >> 4) * 8;
  const bf16* wb = wt + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int chunks = KP / 8;  // 16-byte chunks of a staged row

  for (int t = 0; t < a.T; ++t) {
    const bf16* hprev = t == 0 ? h0 : ys + (size_t)(t - 1) * B * H;
    stage_group_rows(hs, LD, hprev + (size_t)b0 * H, H, nr, H, chunks);

    // this warp's share of K: k tiles warp, warp + 8, ...
    float acc[8][4] = {};
    for (int kt = warp; kt < KP / 16; kt += kWarps) {
      uint32_t af[4];
      attn_mma::ldmatrix_x4(af, ha + kt * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 >= NC) break;
        uint32_t bfr[4];
        attn_mma::ldmatrix_x4(bfr, wb + (size_t)np * 16 * LD + kt * 16);
        attn_mma::mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
        attn_mma::mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
    store_partials(part, PS, acc, NC);
    __syncthreads();

    if (cell) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] = zn[g] + sum_partials(part, PS, r, g * U + u);
      if (PEEP) {
        z[0] += c * p_i;
        z[1] += c * p_f;
      }
      const float ig = sigmoid(z[0]), fg = sigmoid(z[1]), gg = tanhf(z[2]);
      float cn = fg * c + ig * gg;
      if (PEEP) z[3] += cn * p_o;
      const float og = sigmoid(z[3]);
      float hn = og * tanhf(cn);
      if (MASK) {
        hn = m * hn + (1.0f - m) * h;
        cn = m * cn + (1.0f - m) * c;
      }
      h = hn;
      c = cn;
      const size_t o = ((size_t)t * B + b) * H + j;
      ys[o] = __float2bfloat16(hn);
      if (SAVE) {
        gv[0] = ig;
        gv[1] = fg;
        gv[2] = gg;
        gv[3] = og;
        cseq[o] = __float2bfloat16(cn);
      }
      if (t == a.T - 1) {
        static_cast<bf16*>(a.hT)[(size_t)b * H + j] = __float2bfloat16(hn);
        static_cast<bf16*>(a.cT)[(size_t)b * H + j] = __float2bfloat16(cn);
      }
      if (t + 1 < a.T) {  // the next step's inputs, which no block writes
        const bf16* zrow = zx + ((size_t)(t + 1) * B + b) * 4 * H;
#pragma unroll
        for (int g = 0; g < 4; ++g) zn[g] = __bfloat162float(zrow[g * H + j]);
        if (MASK) m = __bfloat162float(mask[(size_t)(t + 1) * B + b]);
      }
    }
    if (t + 1 < a.T) group_arrive(counter);
    if (SAVE && cell) {
      bf16* gr = gates + ((size_t)t * B + b) * 4 * H + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) gr[g * H] = __float2bfloat16(gv[g]);
    }
    // every block of the row group must have written ys[t] before any stages it
    if (t + 1 < a.T) group_wait(counter, (t + 1) * ugroups);
  }
}

// The row-group kernel takes bf16 with H % 8 == 0 (so every staged row holds
// whole 16-byte chunks) and 16-byte aligned operands.
bool mma_operands(const Args& a) {
  const void* ptrs[] = {a.zx, a.w, a.peep, a.h0, a.c0, a.mask, a.ys, a.hT, a.cT, a.gates, a.cseq};
  for (const void* p : ptrs)
    if (!attn_mma::aligned16(p)) return false;
  return a.H % 8 == 0;
}

template <typename T, bool PEEP, bool MASK, bool SAVE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma_operands(a)) {
      static const int units[] = {4, 8, 16};
      const cudaError_t err = launch_row_groups(
          lstm_fwd_mma_kernel<PEEP, MASK, SAVE>, a, units, 3,
          [&](int u) { return mma_smem_bytes(a.H, u); }, stream);
      if (err != cudaErrorInvalidConfiguration) return err;  // else: no plan fits
    }
  }
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
// instance, which also saves the backward's residuals). counters: B int32,
// zero before the launch (the row-group kernel's barriers count there).
// Handles batch rows [r0, r0 + rows) of the (T, B, .) tensors. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dl4j_lstm_fwd(int dtype, const void* zx, const void* w_rec, const void* peep,
                             const void* h0, const void* c0, const void* mask, void* ys,
                             void* hT, void* cT, void* gates, void* cseq, int* counters, int T,
                             int B, int H, int r0, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1 || rows < 1 || r0 < 0 || r0 + rows > B ||
      (gates == nullptr) != (cseq == nullptr) || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{zx, w_rec, peep, h0, c0, mask, ys, hT, cT, gates, cseq, counters, T, B, H, r0, rows,
         0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
