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
// in the forward, neither sets the pace: 256 dependent steps, each with a
// barrier.
//
// Two designs, the mirrors of the forward's (gru_fwd.cu) and lstm_bwd.cu's,
// one cooperative launch per layer per sequence (per group of at most `rows`
// batch rows) each; the C entry point picks one.
//
// bf16 with H % 8 == 0 and 16-byte aligned operands: the row-group kernel,
// gru_bwd_mma_kernel. A block owns a row group of up to 16 batch rows and U
// hidden units (8 or 16; U = 16 at B=64, H=512: 128 blocks), pins the rows
// W_rec[j, :] of its units as they lie (U x 3H bf16, 48 KB at U=16, H=512:
// the "col" B operand of [ds_r, du, round(da*r)] @ W_rec^T), and carries dh
// of each of its cells in the register of the cell's thread. At step t the
// cell threads form [ds_r, du, da] of the block's cells from the residuals
// loaded during the previous step, write dzx[t] and round_T(da * r) to the
// n-third scratch, keep dh * u, and load the residuals of step t-1
// (gates[t-1], zh_n[t-1], ys[t-2] or h0, dys[t-1]), which nothing on the
// recurrence writes; the block meets the other blocks of its row group at a
// counter barrier (lstm_common.cuh), stages the group's 16 rows of
// [dzx[t][:, :2H], scratch] (48 KB) by 16-byte cp.async.cg, and forms dh for
// step t-1 on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32 sums;
// K = 3H, rounded up to whole pairs of k tiles with zeros, split over the 8
// warps, partials summed in shared memory in warp order, so a second launch
// gives the same bits). L2 reads per step: 48 KB a block, 6 MB at the main
// path's shape. Shared memory, 2 (U + 16)(K + 8) + 4 * 8 * 16 (U + 8) bytes
// with K = 3H rounded up to 32: 111 KB at H = 512, U = 16; at H = 1024 156
// KB (U = 8) and 209 KB (U = 16), both within the 227 KB a block may hold
// (U = 16 up to H = 1136, U = 8 up to H = 1544). The plan takes the least U
// whose blocks fit one to an SM, so 16 rows at H = 1024 take U = 8 (128
// blocks), 17-32 rows U = 16 (128 blocks), and 64 rows no plan (256 blocks
// at U = 16): the CUDA-core kernel.
//
// The scratch is a (2, B, H) ping-pong by step parity, race-free under the
// per-group barrier: at step t every block of a group writes half t & 1 of
// its own cells' rows before it arrives at barrier t, and stages the
// group's rows of that half after barrier t; cp_async_wait<0> and the
// __syncthreads after it complete those reads before the block computes the
// products, so before it arrives at barrier t-1. Half t & 1 is written
// again at step t-2, by blocks of the same group only (the group's rows),
// each after it passed barrier t-1, which needs every block of the group to
// have arrived there: no write of half t & 1 at step t-2 can come before
// any block's reads of it at step t. Rows of another group are another
// group's business.
//
// float32, and bf16 that the row-group kernel does not take (H % 8 != 0, an
// unaligned operand, or no plan that fits): the CUDA-core kernel,
// gru_bwd_kernel<T>. Block b owns hidden units [b*U, b*U+U), pins the rows
// W_rec[j, :] of its units (U x 3H) in shared memory, and keeps its units'
// fp32 dh carry there. At step t it computes its units' three dzx columns
// for every row, writes them to dzx[t] and round_T(da * r) to the scratch,
// keeps dh * u, and meets the grid barrier. Then it stages the step's
// recurrent operand of every row, [dzx[t][:2H], scratch], from L2 in row
// chunks with 16-byte loads, and computes its units' dh for step t-1 on the
// CUDA cores. A block writes step t-1's scratch half only after the grid
// barrier that ends every block's reads of step t+1's, which used it.
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
  const void* gates;  // (T, B, 3H) activated [r, u, n] (forward residual)
  const void* zhn;    // (T, B, H) recurrent n pre-activation (forward residual)
  const void* ys;     // (T, B, H) forward output: h_prev of step t is ys[t-1]
  const void* h0;     // (B, H)
  const void* w;      // (H, 3H)
  void* dzx;          // (T, B, 3H) input-projection gradient
  void* dh0;          // (B, H)
  void* scratch;      // (2, B, H) round_T(da * r), ping-pong by step parity
  int* counters;      // (B,) zeroed: the row group from batch row b counts at counters[b]
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

// Shared memory of the row-group kernel: the pinned rows of W_rec (U x LD
// bf16), the staged operand rows (16 x LD bf16) and the 8 warps' partial
// products (8 x 16 x (U + 8) fp32). LD = KP + 8, KP = 3H rounded up to 32
// (whole pairs of k tiles, zero past 3H): an odd number of 16-byte words, so
// the rows an ldmatrix reads fall in different banks.
__host__ __device__ inline int mma_kp(int H) { return (3 * H + 31) & ~31; }

inline size_t mma_smem_bytes(int H, int units) {
  return sizeof(bf16) * (size_t)(units + kGroupRows) * (mma_kp(H) + 8) +
         sizeof(float) * (size_t)(kThreads / 32) * kGroupRows * (units + 8);
}

__global__ void __launch_bounds__(kThreads, 1) gru_bwd_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kWarps = kThreads / 32;
  const int U = a.units, PS = U + 8, H = a.H, B = a.B, K = 3 * H, KP = mma_kp(H), LD = KP + 8;
  const int ugroups = (H + U - 1) / U;
  const int group = blockIdx.x / ugroups, j0 = (blockIdx.x % ugroups) * U;
  const int b0 = a.r0 + group * kGroupRows;
  const int nr = min(kGroupRows, a.r0 + a.rows - b0);
  bf16* ws = reinterpret_cast<bf16*>(smem);      // (U, LD): W_rec[j0 + u, :]
  bf16* dss = ws + (size_t)U * LD;               // (16, LD): staged operand of step t
  float* part = reinterpret_cast<float*>(dss + (size_t)kGroupRows * LD);  // (8, 16, PS)
  int* counter = a.counters + b0;

  const bf16* dys = static_cast<const bf16*>(a.dys);
  const bf16* gates = static_cast<const bf16*>(a.gates);
  const bf16* zhn = static_cast<const bf16*>(a.zhn);
  const bf16* ys = static_cast<const bf16*>(a.ys);
  const bf16* h0 = static_cast<const bf16*>(a.h0);
  const bf16* w = static_cast<const bf16*>(a.w);
  bf16* dzx = static_cast<bf16*>(a.dzx);
  bf16* scratch = static_cast<bf16*>(a.scratch);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = KP / 8;  // 16-byte chunks of a staged row

  // Pin: ws[u, :] = W_rec[j0 + u, :], zero past H and past 3H.
  for (int idx = tid; idx < U * chunks; idx += kThreads) {
    const int uu = idx / chunks, k = (idx % chunks) * 8;
    const bool in = j0 + uu < H && k < K;
    attn_mma::cp_async16(ws + uu * LD + k, in ? w + (size_t)(j0 + uu) * K + k : w, in ? 16 : 0);
  }
  attn_mma::cp_async_commit();

  // This thread's cell: row r of the group, unit u of the block; its
  // residuals of step t are loaded one step ahead.
  const int r = tid / U, u = tid % U, b = b0 + r, j = j0 + u;
  const bool cell = tid < kGroupRows * U && r < nr && j < H;
  float dh = 0.0f, gv[3] = {}, zh = 0.0f, hp = 0.0f, dy = 0.0f;
  auto load_step = [&](int ts) {
    const size_t tb = (size_t)ts * B + b;
    const bf16* gr = gates + tb * 3 * H + j;
#pragma unroll
    for (int g = 0; g < 3; ++g) gv[g] = __bfloat162float(gr[g * H]);
    zh = __bfloat162float(zhn[tb * H + j]);
    hp = __bfloat162float(ts == 0 ? h0[(size_t)b * H + j] : ys[(tb - B) * H + j]);
    dy = __bfloat162float(dys[tb * H + j]);
  };
  if (cell) {
    dh = __bfloat162float(static_cast<const bf16*>(a.dhT)[(size_t)b * H + j]);
    load_step(a.T - 1);
  }
  attn_mma::cp_async_wait<0>();
  __syncthreads();

  // ldmatrix row addresses: A = operand rows (0-7 | 8-15) x (k 0-7 | 8-15);
  // B = W rows n 0-7 at k 0-7, 8-15, 16-23, 24-31 (two k tiles)
  const bf16* oa = dss + (lane & 15) * LD + (lane >> 4) * 8;
  const bf16* wb = ws + (lane & 7) * LD + (lane >> 3) * 8;

  for (int t = a.T - 1; t >= 0; --t) {
    bf16* nthird = scratch + (size_t)(t & 1) * B * H;
    float carry = 0.0f;  // dh * u
    if (cell) {  // dzx[t] and round_T(da * r) for this cell
      const float rg = gv[0], ug = gv[1], ng = gv[2];
      const float dht = dh + dy;
      const float du = dht * (hp - ng) * ug * (1.0f - ug);
      const float da = dht * (1.0f - ug) * (1.0f - ng * ng);
      const float ds_r = da * zh * rg * (1.0f - rg);
      bf16* dr = dzx + ((size_t)t * B + b) * K + j;
      dr[0] = __float2bfloat16(ds_r);
      dr[H] = __float2bfloat16(du);
      dr[2 * H] = __float2bfloat16(da);
      nthird[(size_t)b * H + j] = __float2bfloat16(da * rg);
      carry = dht * ug;
      if (t > 0) load_step(t - 1);  // the next step's residuals, which no block writes
    }
    // every block of the row group must have written dzx[t] and its n-third
    // before any stages them
    group_arrive(counter);
    group_wait(counter, (a.T - t) * ugroups);

    // the group's rows of [dzx[t][:, :2H], n-third], zero past 3H
    const bf16* src = dzx + ((size_t)t * B + b0) * K;
    const bf16* src_n = nthird + (size_t)b0 * H;
    for (int idx = tid; idx < kGroupRows * chunks; idx += kThreads) {
      const int rr = idx / chunks, k = (idx % chunks) * 8;
      const bool in = rr < nr && k < K;
      const bf16* p = !in ? src : k < 2 * H ? src + (size_t)rr * K + k
                                            : src_n + (size_t)rr * H + (k - 2 * H);
      attn_mma::cp_async16(dss + rr * LD + k, p, in ? 16 : 0);
    }
    attn_mma::cp_async_commit();
    attn_mma::cp_async_wait<0>();
    __syncthreads();

    // dh for step t-1: this block's units of the operand @ W_rec^T; this
    // warp's share of K: pairs of k tiles warp, warp + 8, ...
    float acc[2][4] = {};
    for (int kp = warp; kp < KP / 32; kp += kWarps) {
      uint32_t a0[4], a1[4];
      attn_mma::ldmatrix_x4(a0, oa + kp * 32);
      attn_mma::ldmatrix_x4(a1, oa + kp * 32 + 16);
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
    if (cell) dh = carry + sum_partials(part, PS, r, u);
  }

  if (cell) static_cast<bf16*>(a.dh0)[(size_t)b * H + j] = __float2bfloat16(dh);
}

// The row-group kernel takes bf16 with H % 8 == 0 (so every staged row holds
// whole 16-byte chunks) and 16-byte aligned operands.
bool mma_operands(const Args& a) {
  const void* ptrs[] = {a.dys, a.dhT, a.gates, a.zhn, a.ys, a.h0, a.w, a.dzx, a.dh0, a.scratch};
  for (const void* p : ptrs)
    if (!attn_mma::aligned16(p)) return false;
  return a.H % 8 == 0;
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma_operands(a)) {
      static const int units[] = {8, 16};
      const cudaError_t err = launch_row_groups(
          gru_bwd_mma_kernel, a, units, 2, [&](int u) { return mma_smem_bytes(a.H, u); },
          stream);
      if (err != cudaErrorInvalidConfiguration) return err;  // else: no plan fits
    }
  }
  auto smem = [&](int units, int chunk) { return smem_bytes<T>(a.H, a.rows, units, chunk); };
  return launch_cooperative(gru_bwd_kernel<T>, a, smem, sizeof(T) * row_stride<T>(3 * a.H),
                            stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scratch is (2, B, H) of the same dtype,
// written and read by the kernel only. counters: B int32, zero before the
// launch (the row-group kernel's barriers count there). Handles batch rows
// [r0, r0 + rows) of the (T, B, .) tensors. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dl4j_gru_bwd(int dtype, const void* dys, const void* dhT, const void* gates,
                            const void* zhn, const void* ys, const void* h0, const void* w_rec,
                            void* dzx, void* dh0, void* scratch, int* counters, int T, int B,
                            int H, int r0, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1 || rows < 1 || r0 < 0 || r0 + rows > B || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{dys, dhT, gates, zhn, ys, h0, w_rec, dzx, dh0, scratch, counters,
         T, B, H, r0, rows, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
