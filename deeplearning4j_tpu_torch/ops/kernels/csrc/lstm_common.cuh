// Helpers shared by the persistent recurrent kernels (lstm_fwd.cu,
// lstm_bwd.cu, gru_fwd.cu, gru_bwd.cu): storage-type conversions, loads that
// bypass L1, row staging with 16-byte loads, the shared-memory dot product,
// and the launch plan that makes every block of a cooperative grid
// co-resident; for the row-group kernels of both cells (lstm_fwd_mma_kernel,
// lstm_bwd_mma_kernel, gru_fwd_mma_kernel, gru_bwd_mma_kernel), the barrier
// of one row group and their launch plan.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace dl4j_lstm {

constexpr int kThreads = 256;

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

// Loads that bypass L1: the value was written by other blocks before a grid
// barrier, so it must come from L2.
template <typename T> __device__ __forceinline__ T load_l2(const T* p);
template <> __device__ __forceinline__ float load_l2<float>(const float* p) {
  return __ldcg(p);
}
template <> __device__ __forceinline__ __nv_bfloat16 load_l2<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Row stride, in values of T, of n-value rows staged or pinned in shared
// memory: n rounded up to a whole 4-byte word plus one word, so that the rows
// a warp reads at once fall in different banks and every row starts on a
// 4-byte boundary.
template <typename T> __host__ __device__ __forceinline__ int row_stride(int n) {
  constexpr int per_word = (int)(4 / sizeof(T));
  return (n + per_word - 1) / per_word * per_word + per_word;
}

// sum_k a[k] * b[k] over n values of T, in k order, fp32 products and sum;
// a and b are 4-byte aligned shared-memory rows.
template <typename T> __device__ __forceinline__ float dot(const T* a, const T* b, int n);
template <> __device__ __forceinline__ float dot<float>(const float* a, const float* b, int n) {
  float acc = 0.0f;
  for (int k = 0; k < n; ++k) acc = fmaf(a[k], b[k], acc);
  return acc;
}
template <> __device__ __forceinline__ float dot<__nv_bfloat16>(const __nv_bfloat16* a,
                                                               const __nv_bfloat16* b, int n) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b);
  float acc = 0.0f;
  for (int k = 0; k < n / 2; ++k) {
    const float2 x = __bfloat1622float2(a2[k]), y = __bfloat1622float2(b2[k]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  if (n & 1) acc = fmaf(__bfloat162float(a[n - 1]), __bfloat162float(b[n - 1]), acc);
  return acc;
}

// Copy `nr` rows of `n` values of T from global memory (row stride `ld`,
// through L2) to shared memory (row stride S, 4-byte aligned rows). 16-byte
// loads, four in flight per thread, when every source row starts on a
// 16-byte boundary and holds a whole number of them; else one value at a
// time (what cost a step hundreds of serial L2 round trips).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int S, const T* src, int ld, int nr, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kInFlight = 4;
  if (n % kVec == 0 && ld % kVec == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const int nv = n / kVec, total = nr * nv;
    for (int base = threadIdx.x; base < total; base += kInFlight * kThreads) {
      uint4 v[kInFlight];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int idx = base + q * kThreads;
        if (idx < total)
          v[q] = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)(idx / nv) * ld) + idx % nv);
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int idx = base + q * kThreads;
        if (idx < total) {
          unsigned* d = reinterpret_cast<unsigned*>(dst + (size_t)(idx / nv) * S +
                                                    (idx % nv) * kVec);
          d[0] = v[q].x;
          d[1] = v[q].y;
          d[2] = v[q].z;
          d[3] = v[q].w;
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < nr * n; idx += kThreads)
      dst[(size_t)(idx / n) * S + idx % n] = load_l2(src + (size_t)(idx / n) * ld + idx % n);
  }
}

// Pick the hidden units per block and the staged row chunk so that every
// block of the grid is co-resident (a cooperative launch refuses otherwise):
// start from about one block per SM and widen the blocks until they fit.
// `smem(units, chunk)` is the dynamic shared memory of one block and
// `row_bytes` what one more staged row adds. Sets a.units and a.chunk and
// launches; cudaErrorInvalidConfiguration when no plan fits.
template <typename Kernel, typename Args, typename Smem>
cudaError_t launch_cooperative(Kernel kern, Args a, Smem smem, size_t row_bytes,
                               cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  for (int units = (a.H + sms - 1) / sms; units <= a.H; ++units) {
    const size_t fixed = smem(units, 0);
    if (fixed + row_bytes > (size_t)optin) break;
    int chunk = (int)(((size_t)optin - fixed) / row_bytes);
    chunk = chunk < a.rows ? chunk : a.rows;
    const size_t bytes = smem(units, chunk);
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, bytes);
    if (err != cudaSuccess) return err;
    const int blocks = (a.H + units - 1) / units;
    if (blocks > per_sm * sms) continue;
    a.units = units;
    a.chunk = chunk;
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks), dim3(kThreads), params,
                                      bytes, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  return cudaErrorInvalidConfiguration;
}

// Batch rows of a row group: one mma M tile. The row-group kernels give each
// block up to kGroupRows rows and a few hidden units; rows never interact, so
// a block waits only for the blocks of its own row group at each step.
constexpr int kGroupRows = 16;

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The barrier of one row group, in two halves, on one monotonic int32
// counter of the group in global memory (zeroed by the wrapper before the
// launch). group_arrive: once every thread of the block is here (so its
// stores of the step are ordered before), thread 0 adds 1 with release
// semantics at .gpu scope. group_wait: thread 0 spins with acquire loads
// until the counter reaches `target` (the group's blocks times the number of
// barriers passed), then the block goes on; readers of what the other blocks
// wrote then load it through L2 (cp.async.cg). A wait still open after 10 s
// traps, so that a fault fails the launch instead of holding the card.
// Between the halves a block may issue stores that nobody waits for.
__device__ __forceinline__ void group_arrive(int* counter) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(counter), "r"(1) : "memory");
}

__device__ __forceinline__ void group_wait(const int* counter, int target) {
  if (threadIdx.x == 0 && load_acquire(counter) < target) {
    const uint64_t t0 = global_ns();
    while (load_acquire(counter) < target)
      if (global_ns() - t0 > 10000000000ull) __trap();
  }
  __syncthreads();
}

// Rows [0, nr) of a bf16 matrix (row stride ld, 16-byte aligned rows of
// whole 16-byte chunks) to the kGroupRows staged rows of a row-group block
// (row stride LD), `chunks` 16-byte chunks a row, by cp.async.cg (through
// L2: other blocks wrote them); rows past nr and columns past n zero. Waits
// for the copies and for the block.
__device__ __forceinline__ void stage_group_rows(attn_mma::bf16* dst, int LD,
                                                 const attn_mma::bf16* src, int ld, int nr, int n,
                                                 int chunks) {
  for (int idx = threadIdx.x; idx < kGroupRows * chunks; idx += kThreads) {
    const int rr = idx / chunks, k = (idx % chunks) * 8;
    const bool in = rr < nr && k < n;
    attn_mma::cp_async16(dst + rr * LD + k, in ? src + (size_t)rr * ld + k : src, in ? 16 : 0);
  }
  attn_mma::cp_async_commit();
  attn_mma::cp_async_wait<0>();
  __syncthreads();
}

// A warp's m16n8 C fragments of a row-group product (fragment nt: columns
// 8 nt .. 8 nt + 7, those below ncols) into its slice of `part`, the 8
// warps' partial products (8 x kGroupRows x PS fp32).
template <int NT>
__device__ __forceinline__ void store_partials(float* part, int PS, const float (&acc)[NT][4],
                                               int ncols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pw = part + (size_t)warp * kGroupRows * PS + (lane >> 2) * PS + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt * 8 >= ncols) break;
    *reinterpret_cast<float2*>(pw + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(pw + 8 * PS + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Row r, column col of the product: the 8 warps' partials summed in warp
// order, so that a second launch gives the same bits.
__device__ __forceinline__ float sum_partials(const float* part, int PS, int r, int col) {
  const float* pc = part + (size_t)r * PS + col;
  float s = pc[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) s += pc[(size_t)w * kGroupRows * PS];
  return s;
}

// Plan and make one cooperative launch of a row-group kernel over the
// launch's rows: ceil(rows / kGroupRows) row groups times ceil(H / U) unit
// groups of U hidden units, with the least U of `units` (ascending) whose
// blocks fit one to an SM: every block has an SM to itself, and all are
// co-resident, as the barriers need. `smem(U)` is one block's dynamic shared
// memory. Sets a.units. cudaErrorInvalidConfiguration when no plan fits:
// the caller then takes the CUDA-core kernel.
template <typename Kernel, typename Args, typename Smem>
cudaError_t launch_row_groups(Kernel kern, Args a, const int* units, int n_units, Smem smem,
                              cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  const int groups = (a.rows + kGroupRows - 1) / kGroupRows;
  for (int i = 0; i < n_units; ++i) {
    const int blocks = groups * ((a.H + units[i] - 1) / units[i]);
    const size_t bytes = smem(units[i]);
    if (blocks > sms || bytes > (size_t)optin) continue;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) continue;
    a.units = units[i];
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks), dim3(kThreads), params,
                                      bytes, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  return cudaErrorInvalidConfiguration;
}

}  // namespace dl4j_lstm
