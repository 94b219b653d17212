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
// forward, neither sets the pace: 256 dependent steps, each with a barrier.
//
// Two designs, the mirrors of the forward's (lstm_fwd.cu), one cooperative
// launch per layer per sequence (per group of at most `rows` batch rows)
// each; the C entry point picks one.
//
// bf16 with H % 8 == 0 and 16-byte aligned operands: the row-group kernel,
// lstm_bwd_mma_kernel<PEEP, MASK>. A block owns a row group of up to 16
// batch rows and U hidden units (8 or 16; U = 16 at B=64, H=512: 128
// blocks), pins the rows W_rec[j, :] of its units as they lie (U x 4H bf16,
// 64 KB at U=16, H=512: the "col" B operand of ds @ W_rec^T), and carries
// dh and dc of each of its cells in the registers of the cell's thread. At
// step t the cell threads form ds[t] of the block's units from the
// residuals loaded during the previous step, write it, and load the
// residuals of step t-1 (gates[t-1], c_{t-2}, dys[t-1], the mask), which
// nothing on the recurrence writes; the block meets the other blocks of its
// row group at a counter barrier (lstm_common.cuh), stages the group's 16
// rows of ds[t] (64 KB) by 16-byte cp.async.cg, and forms dh for step t-1
// on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32 sums; K = 4H
// split over the 8 warps, partials summed in shared memory in warp order,
// so a second launch gives the same bits). L2 reads per step: 64 KB a
// block, 8 MB at the main path's shape (32 MB with every block staging
// every row, in chunks).
//
// float32, and bf16 that the row-group kernel does not take (H % 8 != 0, an
// unaligned operand, or no plan that fits, as at H = 1024 with 64 rows): the
// CUDA-core kernel, lstm_bwd_kernel<T, PEEP, MASK>. Block b owns hidden
// units [b*U, b*U+U) of every row and pins the rows W_rec[j, :] of its
// units (U x 4H) in shared memory, with its units' fp32 dh/dc carries. At
// step t it computes its units' four ds columns for every row and writes
// them to ds[t], meets the grid barrier, stages ds[t] of every row from L2
// in row chunks (16-byte loads, four in flight per thread; rows padded by
// one 4-byte word against bank conflicts), and computes its units' dh for
// step t-1 on the CUDA cores.
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
  int* counters;      // (B,) zeroed: the row group from batch row b counts at counters[b]
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

// Shared memory of the row-group kernel: the pinned rows of W_rec (U x LD
// bf16), the staged ds rows (16 x LD bf16) and the 8 warps' partial products
// (8 x 16 x (U + 8) fp32). LD = 4H + 8: an odd number of 16-byte words (4H is
// a multiple of 32 values), so the rows an ldmatrix reads fall in different
// banks.
inline size_t mma_smem_bytes(int H, int units) {
  return sizeof(bf16) * (size_t)(units + kGroupRows) * (4 * H + 8) +
         sizeof(float) * (size_t)(kThreads / 32) * kGroupRows * (units + 8);
}

template <bool PEEP, bool MASK>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kWarps = kThreads / 32;
  const int U = a.units, PS = U + 8, H = a.H, B = a.B, K = 4 * H, LD = K + 8;
  const int ugroups = (H + U - 1) / U;
  const int rg = blockIdx.x / ugroups, j0 = (blockIdx.x % ugroups) * U;
  const int b0 = a.r0 + rg * kGroupRows;
  const int nr = min(kGroupRows, a.r0 + a.rows - b0);
  bf16* ws = reinterpret_cast<bf16*>(smem);      // (U, LD): W_rec[j0 + u, :]
  bf16* dss = ws + (size_t)U * LD;               // (16, LD): staged ds[t]
  float* part = reinterpret_cast<float*>(dss + (size_t)kGroupRows * LD);  // (8, 16, PS)
  int* counter = a.counters + b0;

  const bf16* dys = static_cast<const bf16*>(a.dys);
  const bf16* gates = static_cast<const bf16*>(a.gates);
  const bf16* cseq = static_cast<const bf16*>(a.cseq);
  const bf16* c0 = static_cast<const bf16*>(a.c0);
  const bf16* w = static_cast<const bf16*>(a.w);
  const bf16* peep = static_cast<const bf16*>(a.peep);
  const bf16* mask = static_cast<const bf16*>(a.mask);
  bf16* ds = static_cast<bf16*>(a.ds);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = K / 8;  // 16-byte chunks of a row

  // Pin: ws[u, :] = W_rec[j0 + u, :], zero past H.
  for (int idx = tid; idx < U * chunks; idx += kThreads) {
    const int uu = idx / chunks, k = (idx % chunks) * 8;
    const bool in = j0 + uu < H;
    attn_mma::cp_async16(ws + uu * LD + k, in ? w + (size_t)(j0 + uu) * K + k : w, in ? 16 : 0);
  }
  attn_mma::cp_async_commit();

  // This thread's cell: row r of the group, unit u of the block; its
  // residuals of step t are loaded one step ahead.
  const int r = tid / U, u = tid % U, b = b0 + r, j = j0 + u;
  const bool cell = tid < kGroupRows * U && r < nr && j < H;
  float dh = 0.0f, dc = 0.0f, p_i = 0.0f, p_f = 0.0f, p_o = 0.0f;
  float gv[4] = {}, cp = 0.0f, dy = 0.0f, m = 1.0f;
  auto load_step = [&](int ts) {
    const size_t tb = (size_t)ts * B + b;
    const bf16* gr = gates + tb * 4 * H + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) gv[g] = __bfloat162float(gr[g * H]);
    cp = __bfloat162float(ts == 0 ? c0[(size_t)b * H + j] : cseq[(tb - B) * H + j]);
    dy = __bfloat162float(dys[tb * H + j]);
    if (MASK) m = __bfloat162float(mask[tb]);
  };
  if (cell) {
    dh = __bfloat162float(static_cast<const bf16*>(a.dhT)[(size_t)b * H + j]);
    dc = __bfloat162float(static_cast<const bf16*>(a.dcT)[(size_t)b * H + j]);
    if (PEEP) {
      p_i = __bfloat162float(peep[j]);
      p_f = __bfloat162float(peep[H + j]);
      p_o = __bfloat162float(peep[2 * H + j]);
    }
    load_step(a.T - 1);
  }
  attn_mma::cp_async_wait<0>();
  __syncthreads();

  // ldmatrix row addresses: A = ds rows (0-7 | 8-15) x (k 0-7 | 8-15); B = W
  // rows n 0-7 at k 0-7, 8-15, 16-23, 24-31 (two k tiles)
  const bf16* da = dss + (lane & 15) * LD + (lane >> 4) * 8;
  const bf16* wb = ws + (lane & 7) * LD + (lane >> 3) * 8;

  for (int t = a.T - 1; t >= 0; --t) {
    float pass = 0.0f;  // MASK: (1 - m) * dh_ carried past the masked step
    if (cell) {  // ds[t] for this cell, and every carry term but the product
      const float ig = gv[0], fg = gv[1], gg = gv[2], og = gv[3];
      const float tc = tanhf(fg * cp + ig * gg);
      const float dh_tot = dh + dy;
      const float dc_tot = dc;
      const float dh_til = MASK ? m * dh_tot : dh_tot;
      float dc_til = MASK ? m * dc_tot : dc_tot;
      const float d_o = dh_til * tc * og * (1.0f - og);
      dc_til = dc_til + dh_til * og * (1.0f - tc * tc);
      if (PEEP) dc_til += d_o * p_o;
      const float di = dc_til * gg * ig * (1.0f - ig);
      const float df = dc_til * cp * fg * (1.0f - fg);
      const float dg = dc_til * ig * (1.0f - gg * gg);
      bf16* dr = ds + ((size_t)t * B + b) * 4 * H + j;
      dr[0] = __float2bfloat16(di);
      dr[H] = __float2bfloat16(df);
      dr[2 * H] = __float2bfloat16(dg);
      dr[3 * H] = __float2bfloat16(d_o);
      float dc_new = dc_til * fg;
      if (PEEP) {  // in the JAX kernel's order: ((dc~ f + di p_i) + df p_f) + ...
        dc_new += di * p_i;
        dc_new += df * p_f;
      }
      if (MASK) {
        dc_new += (1.0f - m) * dc_tot;
        pass = (1.0f - m) * dh_tot;
      }
      dc = dc_new;
      if (t > 0) load_step(t - 1);  // the next step's residuals, which no block writes
    }
    // every block of the row group must have written ds[t] before any stages it
    group_arrive(counter);
    group_wait(counter, (a.T - t) * ugroups);

    stage_group_rows(dss, LD, ds + ((size_t)t * B + b0) * K, K, nr, K, chunks);

    // dh for step t-1: this block's units of ds[t] @ W_rec^T; this warp's
    // share of K: pairs of k tiles warp, warp + 8, ...
    float acc[2][4] = {};
    for (int kp = warp; kp < K / 32; kp += kWarps) {
      uint32_t a0[4], a1[4];
      attn_mma::ldmatrix_x4(a0, da + kp * 32);
      attn_mma::ldmatrix_x4(a1, da + kp * 32 + 16);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt * 8 >= U) break;
        uint32_t bfr[4];
        attn_mma::ldmatrix_x4(bfr, wb + (size_t)nt * 8 * LD + kp * 32);
        attn_mma::mma_bf16(acc[nt], a0, bfr[0], bfr[1]);
        attn_mma::mma_bf16(acc[nt], a1, bfr[2], bfr[3]);
      }
    }
    store_partials(part, PS, acc, U);
    __syncthreads();
    if (cell) {
      const float prod = sum_partials(part, PS, r, u);
      dh = MASK ? prod + pass : prod;
    }
  }

  if (cell) {
    const size_t o = (size_t)b * H + j;
    static_cast<bf16*>(a.dh0)[o] = __float2bfloat16(dh);
    static_cast<bf16*>(a.dc0)[o] = __float2bfloat16(dc);
  }
}

// The row-group kernel takes bf16 with H % 8 == 0 (so every staged row holds
// whole 16-byte chunks) and 16-byte aligned operands.
bool mma_operands(const Args& a) {
  const void* ptrs[] = {a.dys, a.dhT, a.dcT, a.gates, a.cseq, a.c0, a.w, a.peep, a.mask,
                        a.ds, a.dh0, a.dc0};
  for (const void* p : ptrs)
    if (!attn_mma::aligned16(p)) return false;
  return a.H % 8 == 0;
}

template <typename T, bool PEEP, bool MASK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma_operands(a)) {
      static const int units[] = {8, 16};
      const cudaError_t err = launch_row_groups(
          lstm_bwd_mma_kernel<PEEP, MASK>, a, units, 2,
          [&](int u) { return mma_smem_bytes(a.H, u); }, stream);
      if (err != cudaErrorInvalidConfiguration) return err;  // else: no plan fits
    }
  }
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

// dtype: 0 = float32, 1 = bfloat16. peep and mask may be null. counters: B
// int32, zero before the launch (the row-group kernel's barriers count
// there). Handles batch rows [r0, r0 + rows) of the (T, B, .) tensors.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dl4j_lstm_bwd(int dtype, const void* dys, const void* dhT, const void* dcT,
                             const void* gates, const void* cseq, const void* c0,
                             const void* w_rec, const void* peep, const void* mask, void* ds,
                             void* dh0, void* dc0, int* counters, int T, int B, int H, int r0,
                             int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1 || rows < 1 || r0 < 0 || r0 + rows > B || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{dys, dhT, dcT, gates, cseq, c0, w_rec, peep, mask, ds, dh0, dc0, counters,
         T, B, H, r0, rows, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
