// Helpers shared by the persistent LSTM kernels (lstm_fwd.cu, lstm_bwd.cu):
// storage-type conversions, loads that bypass L1, and the launch plan that
// makes every block of a cooperative grid co-resident.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace dl4j_lstm
