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
// and every step ends in a barrier.
//
// Two designs, one cooperative launch per layer per sequence (per group of
// at most `rows` batch rows) each; the C entry point picks one.
//
// bf16 with H % 8 == 0 and 16-byte aligned operands: the row-group kernel,
// gru_fwd_mma_kernel<SAVE>, lstm_fwd.cu's row-group design with three gates.
// A block owns a row group of up to 16 batch rows (one mma M tile) and U
// hidden units (4, 8 or 16; U = 16 at B=64, H=512: 4 row groups x 32 unit
// groups = 128 blocks). It pins the 3U gate columns j, H+j and 2H+j of its
// units, transposed, in shared memory (3U rounded up to 16 rows of H bf16,
// zero past 3U: 48 KB at U=16), so the r, u and zh_n of a unit, and with
// them n and h', need nothing from another block. Each of its cells (row,
// unit) belongs to one thread, which carries h in fp32 in a register. At
// step t the block stages its 16 rows of h_{t-1} (16 KB) from ys[t-1] (or
// h0) by 16-byte cp.async.cg (through L2: other blocks wrote them), rows
// past the launch's zero-filled; forms the 16 x 3U recurrent products on
// the tensor cores (mma.sync m16n8k16, bf16 operands, fp32 sums; K split
// over the 8 warps, whose partial products are stored in shared memory and
// summed by the cell's thread in warp order, so a second launch gives the
// same bits and a cell's three columns g*U + u cross shared memory once);
// applies the cell, writes its units of ys[t], and meets the other blocks
// of its row group at a counter barrier (lstm_common.cuh): rows never
// interact, so it waits for no other group. Between arrival and wait, where
// nobody waits for them, the saving instance stores the step's gates and
// zh_n and every cell loads zx[t+1]. L2 reads per step: 16 KB a block, 2 MB
// at the main path's shape.
//
// float32, and bf16 that the row-group kernel does not take (H % 8 != 0, an
// unaligned operand, or no plan that fits, as at H = 1024 with 64 rows: 256
// blocks at U = 16): the CUDA-core kernel, gru_fwd_kernel<T, SAVE>. Block b
// owns hidden units [b*U, b*U+U) of every row and pins the 3U columns j,
// H+j, 2H+j of W_rec for them in shared memory, stored as rows; its units'
// fp32 h carry stays in shared memory. At step t it stages h_{t-1} of every
// row from ys[t-1] with 16-byte loads (stage_rows), computes its 3U
// recurrent products for every row on the CUDA cores, applies the cell,
// writes its units of ys[t], and waits at the grid barrier. The saving
// instance keeps the step's residuals in shared memory and stores them after
// the barrier, where they drain while the next step computes.
//
// Limits: a shape that neither design can keep resident is refused with
// cudaErrorInvalidConfiguration, and the wrapper raises.

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace dl4j_lstm;
using attn_mma::bf16;

namespace {

struct Args {
  const void* zx;  // (T, B, 3H)
  const void* w;   // (H, 3H)
  const void* h0;  // (B, H)
  void* ys;        // (T, B, H)
  void* hT;        // (B, H)
  void* gates;     // (T, B, 3H) activated [r, u, n], or null: SAVE only
  void* zhn;       // (T, B, H) recurrent n pre-activation, or null: SAVE only
  int* counters;   // (B,) zeroed: the row group from batch row b counts at counters[b]
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

// Shared memory of the row-group kernel: W_rec's 3U gate columns as rows,
// rounded up to whole 16-row n tiles (NP x LD bf16, zero past 3U), the
// staged h rows (16 x LD bf16), and the 8 warps' partial products (8 x 16 x
// (NP + 8) fp32). LD = H rounded up to 16, plus 8 (tile_ld): an odd number
// of 16-byte words, so the rows an ldmatrix reads fall in different banks.
inline size_t mma_smem_bytes(int H, int units) {
  const int np = attn_mma::round16(3 * units);
  return sizeof(bf16) * (size_t)(np + kGroupRows) * attn_mma::tile_ld(attn_mma::round16(H)) +
         sizeof(float) * (size_t)(kThreads / 32) * kGroupRows * (np + 8);
}

template <bool SAVE>
__global__ void __launch_bounds__(kThreads, 1) gru_fwd_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kWarps = kThreads / 32;
  const int U = a.units, NC = 3 * U, NP = attn_mma::round16(NC), PS = NP + 8;
  const int H = a.H, B = a.B, KP = attn_mma::round16(H), LD = attn_mma::tile_ld(KP);
  const int ugroups = (H + U - 1) / U;
  const int group = blockIdx.x / ugroups, j0 = (blockIdx.x % ugroups) * U;
  const int b0 = a.r0 + group * kGroupRows;
  const int nr = min(kGroupRows, a.r0 + a.rows - b0);
  bf16* wt = reinterpret_cast<bf16*>(smem);      // (NP, LD): column g*U + u of W_rec's slice
  bf16* hs = wt + (size_t)NP * LD;               // (16, LD): staged h_{t-1}
  float* part = reinterpret_cast<float*>(hs + (size_t)kGroupRows * LD);  // (8, 16, PS)
  int* counter = a.counters + b0;

  const bf16* zx = static_cast<const bf16*>(a.zx);
  const bf16* w = static_cast<const bf16*>(a.w);
  const bf16* h0 = static_cast<const bf16*>(a.h0);
  bf16* ys = static_cast<bf16*>(a.ys);
  bf16* gates = static_cast<bf16*>(a.gates);
  bf16* zhn = static_cast<bf16*>(a.zhn);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Pin: wt[g*U + u][k] = W_rec[k, g*H + j0 + u], zero past H (k or j) and
  // past the 3U columns.
  for (int idx = tid; idx < KP * NP; idx += kThreads) {
    const int k = idx / NP, n = idx % NP, j = j0 + n % U;
    wt[(size_t)n * LD + k] = n < NC && k < H && j < H
                                 ? w[(size_t)k * 3 * H + (size_t)(n / U) * H + j]
                                 : __float2bfloat16(0.0f);
  }

  // This thread's cell: row r of the group, unit u of the block; h in fp32.
  const int r = tid / U, u = tid % U, b = b0 + r, j = j0 + u;
  const bool cell = tid < kGroupRows * U && r < nr && j < H;
  float h = 0.0f, zn[3] = {};
  if (cell) {
    h = __bfloat162float(h0[(size_t)b * H + j]);
    const bf16* zrow = zx + (size_t)b * 3 * H;
#pragma unroll
    for (int g = 0; g < 3; ++g) zn[g] = __bfloat162float(zrow[g * H + j]);
  }
  float gv[4] = {};  // SAVE: this step's [r, u, n, zh_n], stored after arrival

  // ldmatrix row addresses: A = h rows (0-7 | 8-15) x (k 0-7 | 8-15); B = W
  // columns n 0-7 (k 0-7 | 8-15), then n 8-15 (k 0-7 | 8-15)
  const bf16* ha = hs + (lane & 15) * LD + (lane >> 4) * 8;
  const bf16* wb = wt + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int chunks = KP / 8;  // 16-byte chunks of a staged row

  for (int t = 0; t < a.T; ++t) {
    const bf16* hprev = t == 0 ? h0 : ys + (size_t)(t - 1) * B * H;
    stage_group_rows(hs, LD, hprev + (size_t)b0 * H, H, nr, H, chunks);

    // this warp's share of K: k tiles warp, warp + 8, ...
    float acc[6][4] = {};
    for (int kt = warp; kt < KP / 16; kt += kWarps) {
      uint32_t af[4];
      attn_mma::ldmatrix_x4(af, ha + kt * 16);
#pragma unroll
      for (int np = 0; np < 3; ++np) {
        if (np * 16 >= NP) break;
        uint32_t bfr[4];
        attn_mma::ldmatrix_x4(bfr, wb + (size_t)np * 16 * LD + kt * 16);
        attn_mma::mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
        attn_mma::mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
    store_partials(part, PS, acc, NC);
    __syncthreads();

    if (cell) {
      float zh[3];  // the cell's three columns g*U + u
#pragma unroll
      for (int g = 0; g < 3; ++g) zh[g] = sum_partials(part, PS, r, g * U + u);
      const float rg = sigmoid(zn[0] + zh[0]);
      const float ug = sigmoid(zn[1] + zh[1]);
      const float ng = tanhf(zn[2] + rg * zh[2]);
      const float hn = (1.0f - ug) * ng + ug * h;
      h = hn;
      const size_t o = ((size_t)t * B + b) * H + j;
      ys[o] = __float2bfloat16(hn);
      if (SAVE) {
        gv[0] = rg;
        gv[1] = ug;
        gv[2] = ng;
        gv[3] = zh[2];
      }
      if (t == a.T - 1) static_cast<bf16*>(a.hT)[(size_t)b * H + j] = __float2bfloat16(hn);
    }
    if (t + 1 < a.T) group_arrive(counter);
    if (cell) {
      const size_t tb = (size_t)t * B + b;
      if (SAVE) {
        bf16* gr = gates + tb * 3 * H + j;
#pragma unroll
        for (int g = 0; g < 3; ++g) gr[g * H] = __float2bfloat16(gv[g]);
        zhn[tb * H + j] = __float2bfloat16(gv[3]);
      }
      if (t + 1 < a.T) {  // the next step's inputs, which no block writes
        const bf16* zrow = zx + (tb + B) * 3 * H;
#pragma unroll
        for (int g = 0; g < 3; ++g) zn[g] = __bfloat162float(zrow[g * H + j]);
      }
    }
    // every block of the row group must have written ys[t] before any stages it
    if (t + 1 < a.T) group_wait(counter, (t + 1) * ugroups);
  }
}

// The row-group kernel takes bf16 with H % 8 == 0 (so every staged row holds
// whole 16-byte chunks) and 16-byte aligned operands.
bool mma_operands(const Args& a) {
  const void* ptrs[] = {a.zx, a.w, a.h0, a.ys, a.hT, a.gates, a.zhn};
  for (const void* p : ptrs)
    if (!attn_mma::aligned16(p)) return false;
  return a.H % 8 == 0;
}

template <typename T, bool SAVE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma_operands(a)) {
      static const int units[] = {4, 8, 16};
      const cudaError_t err = launch_row_groups(
          gru_fwd_mma_kernel<SAVE>, a, units, 3,
          [&](int u) { return mma_smem_bytes(a.H, u); }, stream);
      if (err != cudaErrorInvalidConfiguration) return err;  // else: no plan fits
    }
  }
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
// the backward's residuals). counters: B int32, zero before the launch (the
// row-group kernel's barriers count there). Handles batch rows
// [r0, r0 + rows) of the (T, B, .) tensors. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dl4j_gru_fwd(int dtype, const void* zx, const void* w_rec, const void* h0,
                            void* ys, void* hT, void* gates, void* zhn, int* counters, int T,
                            int B, int H, int r0, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1 || rows < 1 || r0 < 0 || r0 + rows > B ||
      (gates == nullptr) != (zhn == nullptr) || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{zx, w_rec, h0, ys, hT, gates, zhn, counters, T, B, H, r0, rows, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
