// 1x1 convolution as a product with the training-BatchNormalization
// statistics in its epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX repository's
// experiments/resnet_megakernel_stage4.py, pallas_conv_stats (pallas_call at
// :64, body `kernel` at :46-62):
//   y  = x @ w                 (M, K) @ (K, N), f32 accumulator, y stored in T
//   s1 = sum_rows (acc - shift)          (N,) f32, from the accumulator
//   s2 = sum_rows (acc - shift)^2        (N,) f32, before y is rounded
// A zero (or absent) shift gives the Pallas function exactly; the running
// mean as the shift keeps BatchNormalization's guard against cancellation
// in E[d^2] - E[d]^2 (the JAX package's nn/conv_layers.py:241-250).
//
// The TPU grid runs its row blocks in order and carries the two sums in
// scratch from one step to the next (:50-53). Here the row blocks run in
// parallel in no order, so each block writes its own partial sums (one row
// of part1/part2 per 128-row block) and a second kernel adds the partials of
// each column in a fixed order. No float atomics: two launches on the same
// inputs agree bit for bit, so the statistics are reproducible.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at row 13's shape
// (12544, 2048) @ (2048, 512) bf16, 26.3 GFLOP = 0.0266 ms of tensor-core
// time against x 51.4 MB + w 2.1 MB + y 12.8 MB = 66.3 MB = 0.0198 ms:
// operations bound it. At stage 0 of ResNet-50 (K = 64,
// (802816, 64) @ (64, 256)) the bytes do: x 102.8 MB + y 411.0 MB = 0.153 ms
// against 26.3 GFLOP = 0.0266 ms.
//
// Design (right and simple first): a 128 x 128 output tile per block of 256
// threads (8 warps, 2 along M x 4 along N, 64 x 32 each), K in steps of 32
// through shared memory. bf16 runs mma.sync.m16n8k16 on the tensor cores
// with f32 accumulators; fp32 (for checking on the card) runs the same tile
// layout with CUDA-core FMAs in full fp32. Each thread owns the C-fragment
// positions of mma.sync either way, so the epilogue is one code: store y,
// sum each owned column over the owned rows, then a fixed butterfly over
// the 8 row groups of a warp and a fixed sum over the 2 warps along M.
// Ragged M, K and N are masked (zero-filled tiles, rows past M left out of
// the sums). No cp.async pipeline, no TMA, no wgmma: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;   // rows of the output tile
constexpr int kBN = 128;   // columns of the output tile
constexpr int kBK = 32;    // depth of one shared-memory step
constexpr int kPad = 8;    // row padding of the tiles: conflict-free fragment reads
constexpr int kLd = kBK + kPad;
constexpr int kThreads = 256;
constexpr int kSumThreadsX = 32;  // column sums: 32 columns x 32 row lanes a block
constexpr int kSumThreadsY = 32;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Eight consecutive T values of one row, as one (bf16) or two (fp32) 16-byte
// accesses.
template <typename T> struct alignas(16) Pack8 { T t[8]; };
template <typename T> struct alignas(2 * sizeof(T)) Pack2 { T t[2]; };

// Loads 8 elements src[0..7] of a row whose valid length from src is
// `valid` (<= 0: none); zero past it. `vec`: 16-byte aligned and whole.
template <typename T>
__device__ __forceinline__ Pack8<T> load8(const T* src, int valid, bool vec) {
  Pack8<T> p;
  if (vec && valid >= 8) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(&p);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Pack8<T>) / 16); ++i) d[i] = s[i];
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) p.t[e] = e < valid ? src[e] : from_f<T>(0.0f);
  }
  return p;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One K step of the warp's 64 x 32 tile. acc[mt][nt][i] is the C fragment of
// m16n8 tile (mt, nt): row g + 8 * (i >> 1), column 2 * t + (i & 1).
template <typename T> struct Mac;

template <> struct Mac<__nv_bfloat16> {
  __device__ __forceinline__ static void run(float (&acc)[4][4][4],
                                             const __nv_bfloat16 (*As)[kLd],
                                             const __nv_bfloat16 (*Bs)[kLd], int rb, int cb,
                                             int g, int t) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = rb + mt * 16 + g;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t + 8]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = cb + nt * 8 + g;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 2 * t]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }
};

template <> struct Mac<float> {
  __device__ __forceinline__ static void run(float (&acc)[4][4][4], const float (*As)[kLd],
                                             const float (*Bs)[kLd], int rb, int cb, int g,
                                             int t) {
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4][2], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) a[mt][h] = As[rb + mt * 16 + g + 8 * h][kk];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) b[nt][j] = Bs[cb + nt * 8 + 2 * t + j][kk];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] = __fmaf_rn(a[mt][i >> 1], b[nt][i & 1], acc[mt][nt][i]);
    }
  }
};

// grid (ceil(M / 128), ceil(N / 128)); part1/part2 hold gridDim.x rows of N.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ shift, T* __restrict__ y,
                      float* __restrict__ part1, float* __restrict__ part2, int M, int K, int N,
                      bool vec) {
  __shared__ __align__(16) T As[kBM][kLd];  // x tile, [row][k]
  __shared__ __align__(16) T Bs[kBN][kLd];  // w tile transposed, [column][k]
  __shared__ float red1[2][kBN], red2[2][kBN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp_m * 64, cb = warp_n * 32;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's reads are done
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {
      // x: 128 rows x 4 chunks of 8
      const int idx = tid + rep * kThreads;
      const int r = idx >> 2, c = (idx & 3) * 8;
      const long long row = m0 + r;
      const int valid = row < M ? K - (k0 + c) : 0;
      const Pack8<T> p = load8<T>(x + (row < M ? row * K + k0 + c : 0), valid, vec);
      *reinterpret_cast<Pack8<T>*>(&As[r][c]) = p;
    }
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {
      // w: 32 rows of k x 16 chunks of 8 columns, stored transposed
      const int idx = tid + rep * kThreads;
      const int kr = idx >> 4, c = (idx & 15) * 8;
      const int k = k0 + kr;
      const int valid = k < K ? N - (n0 + c) : 0;
      const Pack8<T> p = load8<T>(w + (k < K ? (long long)k * N + n0 + c : 0), valid, vec);
#pragma unroll
      for (int e = 0; e < 8; ++e) Bs[c + e][kr] = p.t[e];
    }
    __syncthreads();
    Mac<T>::run(acc, As, Bs, rb, cb, g, t);
  }

  // ---- epilogue: y (two neighbouring columns a store where whole), then
  // the column sums of (acc - shift) and its square over the valid rows
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + rb + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + cb + nt * 8 + 2 * t;
        const T v0 = from_f<T>(acc[mt][nt][2 * h]), v1 = from_f<T>(acc[mt][nt][2 * h + 1]);
        if (vec && col + 1 < N) {
          Pack2<T> p;
          p.t[0] = v0;
          p.t[1] = v1;
          *reinterpret_cast<Pack2<T>*>(y + row * N + col) = p;
        } else {
          if (col < N) y[row * N + col] = v0;
          if (col + 1 < N) y[row * N + col + 1] = v1;
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cl = cb + nt * 8 + 2 * t + j;  // column within the tile
      const int col = n0 + cl;
      const float sh = (shift != nullptr && col < N) ? shift[col] : 0.0f;
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = m0 + rb + mt * 16 + g + 8 * h;
          if (row < M) {
            const float d = acc[mt][nt][2 * h + j] - sh;
            s1 += d;
            s2 = __fmaf_rn(d, d, s2);
          }
        }
      }
      // the 8 row groups of the warp: lanes t, t + 4, ..., t + 28
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (g == 0) {
        red1[warp_m][cl] = s1;
        red2[warp_m][cl] = s2;
      }
    }
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < N) {
    part1[(long long)blockIdx.x * N + n0 + tid] = red1[0][tid] + red1[1][tid];
    part2[(long long)blockIdx.x * N + n0 + tid] = red2[0][tid] + red2[1][tid];
  }
}

// s[col] = sum over the row blocks of part[b][col], in a fixed order: lane
// y of a block adds rows y, y + 32, ... in turn, then lane 0 adds the 32
// lanes' sums in turn.
__global__ void __launch_bounds__(kSumThreadsX * kSumThreadsY)
    column_sums_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                       float* __restrict__ s1, float* __restrict__ s2, int blocks, int N) {
  __shared__ float r1[kSumThreadsY][kSumThreadsX + 1], r2[kSumThreadsY][kSumThreadsX + 1];
  const int cx = threadIdx.x, ry = threadIdx.y;
  const int col = blockIdx.x * kSumThreadsX + cx;
  float a = 0.0f, b = 0.0f;
  if (col < N) {
    for (int i = ry; i < blocks; i += kSumThreadsY) {
      a += part1[(long long)i * N + col];
      b += part2[(long long)i * N + col];
    }
  }
  r1[ry][cx] = a;
  r2[ry][cx] = b;
  __syncthreads();
  if (ry == 0 && col < N) {
    float sa = 0.0f, sb = 0.0f;
    for (int i = 0; i < kSumThreadsY; ++i) {
      sa += r1[i][cx];
      sb += r2[i][cx];
    }
    s1[col] = sa;
    s2[col] = sb;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* shift, void* y, float* part1,
                   float* part2, float* s1, float* s2, int M, int K, int N,
                   cudaStream_t stream) {
  const bool vec = K % 8 == 0 && N % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0 && (uintptr_t)y % 16 == 0;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + kBN - 1) / kBN));
  conv_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), shift, static_cast<T*>(y), part1,
      part2, M, K, N, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 sum_block(kSumThreadsX, kSumThreadsY);
  column_sums_kernel<<<(unsigned)((N + kSumThreadsX - 1) / kSumThreadsX), sum_block, 0,
                       stream>>>(part1, part2, s1, s2, (int)grid.x, N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (M, K) and w (K, N) row-major in the
// dtype, shift (N,) float32 or null, y (M, N) in the dtype; part1/part2 hold
// ceil(M / 128) x N floats of scratch; s1/s2 (N,) float32. Returns the
// launches' cudaError_t.
extern "C" int dl4j_conv_stats(int dtype, const void* x, const void* w, const float* shift,
                               void* y, float* part1, float* part2, float* s1, float* s2,
                               int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, shift, y, part1, part2, s1, s2, M, K, N, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, shift, y, part1, part2, s1, s2, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

// Rows of part1/part2 a launch at M rows needs.
extern "C" int dl4j_conv_stats_blocks(int M) { return (M + kBM - 1) / kBM; }

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
