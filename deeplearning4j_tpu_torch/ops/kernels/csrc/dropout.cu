// Fused inverted dropout (+ optional residual add) for Hopper (sm_90a), one
// kernel for both passes.
//
// Replaces the Pallas TPU kernel of the JAX package's
// deeplearning4j_tpu/ops/pallas/fused_dropout.py, _call (pallas_call at :124)
// running _fwd_kernel (:55) or _bwd_kernel (:66). Over n flat elements:
//   y[i] = x[i] + (bits[i] < thresh ? h[i] * inv_keep : 0)     (x optional)
// The backward is the same launch on gy with no x (dh), so the mask is drawn
// again and never stored.
//
// Semantics, as the Pallas kernel's:
//   - thresh = min(int(keep * 2^32), 2^32 - 1), compared unsigned;
//   - h * inv_keep is rounded to T, with inv_keep already a T value (the
//     wrapper rounds it), then x is added and the sum rounded to T. Both
//     steps are separate IEEE operations (__fmul_rn, __fadd_rn): a fused
//     multiply-add would change the bits;
//   - a dropped element is x + 0 (so -0.0 in x becomes +0.0, as in JAX).
//
// Random bits: Philox4x32-10 with key (seed, 0) and counter (j mod 2^32,
// j >> 32, 0, 0), j = i / 4; element i takes word i % 4. They depend on the
// element's index and the seed alone, so the plain torch version in
// fused_dropout.py reproduces them bit for bit whatever the grid.
//
// Bound at the bench's shape (8192 x 768 bf16, no x): h read once and y
// written once, 2 x 12.6 MB, 7.5 us at 3.35 TB/s; with x, 11.3 us. No
// product: bytes. The ~40 integer operations of one Philox call per 4
// elements are far below the card's integer rate.
//
// Design (right and simple): a grid-stride loop in which each thread makes
// one Philox call and takes the 4 elements of its counter, with one 16-byte
// (float) or 8-byte (bf16) load per operand and store where every pointer is
// aligned to it and the 4 elements are whole; the tail of 1-3 elements and
// unaligned views take scalar accesses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each of the 132 SMs

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// One element: the product rounded to T, then the residual added and rounded.
template <typename T>
__device__ __forceinline__ T drop(T h, const T* x, long long i, bool kept, float inv_keep) {
  const float y = kept ? to_f(from_f<T>(__fmul_rn(to_f(h), inv_keep))) : 0.0f;
  return from_f<T>(x ? __fadd_rn(to_f(x[i]), y) : y);
}

// Four T values moved as one access: 16 bytes of float, 8 of bf16.
template <typename T> struct alignas(4 * sizeof(T)) Pack { T t[4]; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ h, const T* __restrict__ x, T* __restrict__ y,
                   long long n, uint32_t seed, uint32_t thresh, float inv_keep, bool vec) {
  const long long n_ctr = (n + 3) / 4;
  const uint2 key = make_uint2(seed, 0u);
  for (long long j = blockIdx.x * (long long)kThreads + threadIdx.x; j < n_ctr;
       j += (long long)gridDim.x * kThreads) {
    const uint4 bits = philox4x32_10(
        make_uint4((uint32_t)j, (uint32_t)((unsigned long long)j >> 32), 0u, 0u), key);
    const bool kept[4] = {bits.x < thresh, bits.y < thresh, bits.z < thresh, bits.w < thresh};
    const long long i0 = 4 * j;
    if (vec && i0 + 4 <= n) {
      const Pack<T> hv = reinterpret_cast<const Pack<T>*>(h)[j];
      Pack<T> xv, yv;
      if (x) xv = reinterpret_cast<const Pack<T>*>(x)[j];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        yv.t[e] = drop<T>(hv.t[e], x ? xv.t : nullptr, e, kept[e], inv_keep);
      reinterpret_cast<Pack<T>*>(y)[j] = yv;
    } else {
      for (int e = 0; e < 4 && i0 + e < n; ++e)
        y[i0 + e] = drop<T>(h[i0 + e], x, i0 + e, kept[e], inv_keep);
    }
  }
}

template <typename T>
cudaError_t launch(const void* h, const void* x, void* y, long long n, uint32_t seed,
                   uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const size_t align = sizeof(Pack<T>);
  const bool vec = (uintptr_t)h % align == 0 && (uintptr_t)y % align == 0 &&
                   (!x || (uintptr_t)x % align == 0);
  const long long n_ctr = (n + 3) / 4;
  long long blocks = (n_ctr + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dropout_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(x), static_cast<T*>(y), n, seed, thresh,
      inv_keep, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. h, y (and x, which may be null) hold n
// contiguous elements; seed is the int32 seed's bit pattern; inv_keep is
// 1 / keep already rounded to the dtype. Returns the launch's cudaError_t.
extern "C" int dl4j_dropout(int dtype, const void* h, const void* x, void* y, long long n,
                            unsigned int seed, unsigned int thresh, float inv_keep,
                            void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(h, x, y, n, seed, thresh, inv_keep, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(h, x, y, n, seed, thresh, inv_keep, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
