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
// parallel in no order, so each 128-row block of x gets its own row of
// partial sums in part1/part2, whichever CUDA block computed it, and a
// second kernel adds the partials of each column in a fixed order. No float
// atomics: two launches on the same inputs agree bit for bit, so the
// statistics are reproducible.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at row 13's shape
// (12544, 2048) @ (2048, 512) bf16, 26.3 GFLOP = 0.0266 ms of tensor-core
// time against x 51.4 MB + w 2.1 MB + y 12.8 MB = 66.3 MB = 0.0198 ms:
// operations bound it. At stage 0 of ResNet-50 (K = 64,
// (802816, 64) @ (64, 256)) the bytes do: x 102.8 MB + y 411.0 MB = 0.153 ms
// against 26.3 GFLOP = 0.0266 ms.
//
// Two kernels compute the tile products, chosen by the launcher (`launch`,
// below) from the dtype and the alignment alone:
//
// bf16 whose x, w and y start on 16-byte boundaries with K % 8 == 0 and
// N % 8 == 0 (TMA's own conditions: 16-byte base addresses, row strides a
// multiple of 16 bytes) runs conv_stats_wgmma_kernel<BN>. Every ResNet-50
// pair is such a product (K and N are multiples of 64).
//  - Roles: a producer warpgroup, of which one thread issues every copy,
//    and two consumer warpgroups. The producer keeps a ring of shared-memory
//    stages full with TMA (cp.async.bulk.tensor, 128-byte swizzle): per
//    stage a 128 x 64 box of x (16 KB) and BN / 64 boxes of 64 k-rows x 64
//    columns of w (8 KB each).
//    An mbarrier per stage counts the bytes in (expect_tx), a second one the
//    8 consumer warps out. TMA zero-fills rows past M, columns past K and N.
//  - Products: each consumer warpgroup owns 64 rows of a 128 x BN output
//    tile and runs wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulators in
//    registers), A and B straight from the swizzled stages: x is K-major as
//    it lies; w (K, N) row-major is B in N-major form through wgmma's
//    transpose bit, so nothing is transposed in the loop. One wgmma group
//    stays in flight while the previous stage is handed back.
//  - BN = 64 for N <= 64, 128 for N <= 128, else 256, so that the K = 64
//    shapes of ResNet-50's stage 0 read their x rows once; but 128 also
//    where 128 x 256 tiles would fill the SMs three times or less. Row 13's
//    shape has 196 such tiles for 132 SMs; at BN = 128 it takes 0.042 ms
//    against 0.051, and (50176, 1024, 256) 0.055 against 0.060, while at 784
//    tiles and more BN = 256 is as fast or up to 11% faster (chip_ab.py
//    conv_stats_tiles). The sums do not depend on BN. The ring is as
//    deep as the 227 KB of shared memory allows beside the y tile (128 x BN
//    bf16) and the per-warp sums (8 x 2 x BN f32): 3 stages of 48 KB at
//    BN = 256, 5 of 32 KB at 128, 8 of 24 KB at 64. setmaxnreg gives the
//    consumers 232 registers (128 accumulators a thread at BN = 256) and
//    the producer 40; it moves registers by warpgroup, so the producer is
//    a whole warpgroup (384 threads: 168 registers each at entry).
//  - Persistent walk: one block an SM (at most), block b takes tiles b,
//    b + grid, ... with the N tiles of an M tile innermost, so that the
//    blocks that read the same x rows run side by side and share them in
//    L2. The producer runs ahead into the next tile's loads while the
//    consumers run the epilogue, which is what the K = 64 shapes need: a
//    tile there has one K step.
//  - Epilogue: y is rounded to bf16 into shared memory in the boxes'
//    swizzled layout (conflict-free 4-byte stores) and written by TMA
//    stores (rows past M and columns past N are not written). The column
//    sums come from the f32 accumulators: rows past M left out (their zero
//    rows give acc = 0, and 0 - shift is not 0); then a fixed reduction:
//    each lane's two rows, a halving exchange over the 8 row lanes of a
//    warp (three shuffle rounds, each lane keeping half of what it holds),
//    then the 8 warps in order through shared memory. One partial row per
//    128-row M tile goes to part1/part2, whichever block computed it, so
//    the bits depend neither on the grid size nor on which block took
//    which tile.
//
// float32 (the card's check of the algorithm) and any other bf16 input run
// conv_stats_kernel<T>: a 128 x 128 output tile per block of 256 threads (8
// warps, 2 along M x 4 along N, 64 x 32 each), K in steps of 32 through
// shared memory, loaded through registers (16 bytes a thread where aligned,
// element by element otherwise). bf16 runs mma.sync.m16n8k16 with f32
// accumulators, fp32 the same tile layout with CUDA-core FMAs in full fp32.
// Each thread owns the C-fragment positions of mma.sync either way, so the
// epilogue is one code: store y, sum each owned column over the owned rows,
// then a fixed butterfly over the 8 row groups of a warp and a fixed sum
// over the 2 warps along M. Ragged M, K and N are masked.
//
// Either way column_sums_kernel then adds the partial rows of each column in
// a fixed order (one launch of the library is the two kernels).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, device
// time of both kernels: row 13's shape 0.042 ms (64% of its bound; the
// mma.sync kernel took 0.545-0.552, torch.matmul + the two sums take 0.111);
// stage 0's (802816, 64) @ (64, 256) 0.232 ms (66% of its 0.153 bound); the
// 36 launches of a ResNet-50 training step 3.6 ms (18.4 before).
//
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so the library links no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// ------------------------------------------------------------------ bf16 on wgmma

constexpr int kWgBK = 64;                       // K depth of a stage: a 128-byte bf16 row
constexpr int kWgConsumers = 256;               // two warpgroups of 64 output rows
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer's warpgroup
constexpr int kXBytes = kBM * kWgBK * 2;        // an x stage: 128 rows of 128 bytes
constexpr int kBoxBytes = 64 * 128;             // a w or y box: 64 rows of 128 bytes
constexpr int kSwizzleSpan = 1024;              // the 128-byte swizzle repeats every 8 rows
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int BN>
struct WgTile {
  static constexpr int kStages = BN == 256 ? 3 : BN == 128 ? 5 : 8;
  static constexpr int kBoxes = BN / 64;              // 64-column boxes of w and of y
  static constexpr int kWBytes = kBoxes * kBoxBytes;  // a w stage: 64 k-rows x BN
  static constexpr int kYBytes = 2 * kBoxes * kBoxBytes;
  static constexpr int kRedBytes = (8 * 2 + 1) * BN * 4;  // each warp's s1 and s2, the shift
  static constexpr int kSmem =
      kSwizzleSpan + kStages * (kXBytes + kWBytes) + kYBytes + kRedBytes + 2 * kStages * 8;
};
static_assert(WgTile<256>::kSmem <= 232448 && WgTile<128>::kSmem <= 232448 &&
                  WgTile<64>::kSmem <= 232448,
              "a block has at most 227 KB of shared memory");
static_assert(kWgConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the register file holds both roles");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of this parity has completed. A phase
// still open 10 s after the first try traps, so that a fault in the ring
// fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Descriptor of a wgmma operand in shared memory laid out by TMA's 128-byte
// swizzle (layout type 1, bits 62-63): start address, leading and stride
// byte offsets, each in 16-byte units. K-major x: rows of 128 bytes, 8-row
// groups 1024 bytes apart (the stride offset; the leading one is unused).
// N-major w: k-rows of 128 bytes, 8-k-row groups 1024 bytes apart (stride),
// 64-column boxes kBoxBytes apart (leading).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x BN, f32; thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// (+ 8) and columns 8 j + 2 (t % 4) (+ 1)) += A (64 x 16, K-major) B (16 x BN,
// N-major: transpose bit 1). The scale-d predicate is set from a constant 1:
// every product accumulates.
template <int BN>
__device__ __forceinline__ void wgmma_tn(float* d, uint64_t da, uint64_t db);

#define CS_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
template <>
__device__ __forceinline__ void wgmma_tn<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : CS_F4(0), CS_F4(4), CS_F4(8), CS_F4(12), CS_F4(16), CS_F4(20), CS_F4(24), CS_F4(28)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : CS_F4(0), CS_F4(4), CS_F4(8), CS_F4(12), CS_F4(16), CS_F4(20), CS_F4(24), CS_F4(28),
        CS_F4(32), CS_F4(36), CS_F4(40), CS_F4(44), CS_F4(48), CS_F4(52), CS_F4(56), CS_F4(60)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<256>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : CS_F4(0), CS_F4(4), CS_F4(8), CS_F4(12), CS_F4(16), CS_F4(20), CS_F4(24), CS_F4(28),
        CS_F4(32), CS_F4(36), CS_F4(40), CS_F4(44), CS_F4(48), CS_F4(52), CS_F4(56), CS_F4(60),
        CS_F4(64), CS_F4(68), CS_F4(72), CS_F4(76), CS_F4(80), CS_F4(84), CS_F4(88), CS_F4(92),
        CS_F4(96), CS_F4(100), CS_F4(104), CS_F4(108), CS_F4(112), CS_F4(116), CS_F4(120),
        CS_F4(124)
      : "l"(da), "l"(db), "r"(1));
}
#undef CS_F4

// v[0 .. V) of the lanes that differ in lane bit OFF summed pairwise: the
// lane with the bit clear keeps the sums of the first half in v[0 .. V/2),
// the other lane those of the second half. A fixed order: bit for bit.
template <int V, int OFF>
__device__ __forceinline__ void reduce_halves(float* v, int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float send = upper ? v[i] : v[i + V / 2];
    const float keep = upper ? v[i + V / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Persistent: grid <= the SMs; part1/part2 hold ceil(M / 128) rows of N.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv_stats_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                            const __grid_constant__ CUtensorMap tmap_w,
                            const __grid_constant__ CUtensorMap tmap_y,
                            const float* __restrict__ shift, float* __restrict__ part1,
                            float* __restrict__ part2, int M, int K, int N) {
  using Tile = WgTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kSwizzleSpan - 1) & ~(uint32_t)(kSwizzleSpan - 1);
  const uint32_t x_ring = base;
  const uint32_t w_ring = x_ring + Tile::kStages * kXBytes;
  const uint32_t y_tile = w_ring + Tile::kStages * Tile::kWBytes;
  float* const red = reinterpret_cast<float*>(smem_raw + (y_tile - raw) + Tile::kYBytes);
  float* const shift_s = red + 2 * kWgConsumers / 32 * BN;  // the tile's BN shifts
  const uint32_t full = y_tile + Tile::kYBytes + Tile::kRedBytes;  // a barrier per stage
  const uint32_t empty = full + 8 * Tile::kStages;                 // and another

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * n_tiles;
  const int k_steps = (K + kWgBK - 1) / kWgBK;

  if (tid == 0) {
    for (int s = 0; s < Tile::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWgConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // ---- producer: one thread keeps the ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kWgConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * BN;
        const int boxes = min(Tile::kBoxes, (N - n0 + 63) / 64);  // none wholly past N
        const uint32_t bytes = kXBytes + boxes * kBoxBytes;
        for (int ks = 0; ks < k_steps; ++ks) {
          const uint32_t bar = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, bytes);
          tma_load(x_ring + stage * kXBytes, &tmap_x, bar, ks * kWgBK, m0);
          for (int b = 0; b < boxes; ++b)
            tma_load(w_ring + stage * Tile::kWBytes + b * kBoxBytes, &tmap_w, bar, n0 + 64 * b,
                     ks * kWgBK);
          if (++stage == Tile::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
    const int r0 = (warp & 3) * 16 + g;  // this thread's rows r0 and r0 + 8 of the 64
    const bool issuer = (tid & 127) == 0;
    const uint32_t y_half = y_tile + wg * Tile::kBoxes * kBoxBytes;
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile / n_tiles;
      const int m0 = mt * kBM, n0 = tile % n_tiles * BN;
      int held = 0;  // the stage whose products may still be in flight
      // Zeroed here and accumulated by every product: a scale-d of 0 on the
      // first product, a runtime predicate, makes ptxas wait for each
      // stage's products before the next stage (C7517), 13-19% slower at
      // the shapes bound by operations (chip_ab.py conv_stats_scale_d).
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t xs = x_ring + stage * kXBytes + wg * (kXBytes / 2);
        const uint32_t ws = w_ring + stage * Tile::kWBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
          wgmma_tn<BN>(acc, sw128_desc(xs + 32 * kk, 16, kSwizzleSpan),
                       sw128_desc(ws + 16 * 128 * kk, kBoxBytes, kSwizzleSpan));
        wgmma_commit();
        if (ks > 0) {  // the previous stage's products are done: hand it back
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + 8 * held);
        }
        held = stage;
        if (++stage == Tile::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(acc);
      if (lane == 0) mbar_arrive(empty + 8 * held);

      // ---- y: bf16 into the swizzled layout of this warpgroup's 64-row boxes
      if (issuer) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      if (tid < BN)
        shift_s[tid] = shift != nullptr && n0 + tid < N ? __ldg(shift + n0 + tid) : 0.0f;
      // the previous tile's y has left shared memory, its sums and shifts are read
      named_sync(3, kWgConsumers);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;  // r % 8 == g
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          const uint32_t at =
              y_half + (j >> 3) * kBoxBytes + r * 128 + (((j & 7) ^ g) << 4) + 4 * q;
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + wg, 128);
      if (issuer && m0 + 64 * wg < M) {
        for (int b = 0; b < Tile::kBoxes && n0 + 64 * b < N; ++b)
          tma_store(&tmap_y, y_half + b * kBoxBytes, n0 + 64 * b, m0 + 64 * wg);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }

      // ---- the column sums of (acc - shift) and its square over rows < M:
      // the thread's two rows in place of its accumulators (s1 at 4 j + e,
      // s2 at 4 j + 2 + e for column 8 j + 2 q + e), then the warp's 8 row
      // lanes in three halving rounds (lane bits 2, 3, 4)
      const bool ok0 = m0 + 64 * wg + r0 < M, ok1 = m0 + 64 * wg + r0 + 8 < M;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sh = shift_s[8 * j + 2 * q + e];
          const float d0 = ok0 ? acc[4 * j + e] - sh : 0.0f;
          const float d1 = ok1 ? acc[4 * j + 2 + e] - sh : 0.0f;
          acc[4 * j + e] = d0 + d1;
          acc[4 * j + 2 + e] = __fmaf_rn(d1, d1, d0 * d0);
        }
      }
      reduce_halves<BN / 2, 4>(acc, lane);
      reduce_halves<BN / 4, 8>(acc, lane);
      reduce_halves<BN / 8, 16>(acc, lane);
      // the lane now holds entries first .. first + BN / 16 of the 4-per-j order
      const int first =
          (lane & 4 ? BN / 4 : 0) + (lane & 8 ? BN / 8 : 0) + (lane & 16 ? BN / 16 : 0);
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int idx = first + i;
        red[(2 * warp + ((idx >> 1) & 1)) * BN + 8 * (idx >> 2) + 2 * q + (idx & 1)] = acc[i];
      }
      named_sync(3, kWgConsumers);
      for (int c = tid; c < BN && n0 + c < N; c += kWgConsumers) {
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < kWgConsumers / 32; ++w8) {  // warps in order
          s1 += red[2 * w8 * BN + c];
          s2 += red[(2 * w8 + 1) * BN + c];
        }
        part1[(long long)mt * N + n0 + c] = s1;
        part2[(long long)mt * N + n0 + c] = s2;
      }
    }
    if (issuer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a row-major bf16 (rows, cols) array in boxes of
// box_rows x 64 columns (128 bytes: the swizzle's width), 128-byte swizzle.
bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

long long wgmma_tiles(int M, int N, int BN) {
  return (long long)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w, const float* shift, void* y,
                         float* part1, float* part2, int M, int K, int N, int sms,
                         cudaStream_t stream) {
  CUtensorMap tx, tw, ty;
  if (!tensor_map(&tx, x, M, K, kBM) || !tensor_map(&tw, w, K, N, 64) ||
      !tensor_map(&ty, y, M, N, 64))
    return cudaErrorInvalidValue;
  const long long tiles = wgmma_tiles(M, N, BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_stats_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, WgTile<BN>::kSmem);
  if (err != cudaSuccess) return err;
  const int grid = (int)std::min<long long>(tiles, sms);
  conv_stats_wgmma_kernel<BN><<<grid, kWgThreads, WgTile<BN>::kSmem, stream>>>(
      tx, tw, ty, shift, part1, part2, M, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* shift, void* y, float* part1,
                   float* part2, float* s1, float* s2, int M, int K, int N,
                   cudaStream_t stream) {
  const bool aligned = K % 8 == 0 && N % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)w % 16 == 0 && (uintptr_t)y % 16 == 0;
  const unsigned blocks = (unsigned)((M + kBM - 1) / kBM);
  cudaError_t err;
  if (std::is_same<T, __nv_bfloat16>::value && aligned) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    // BN = 128 also where 128 x 256 tiles would fill the SMs 3 times or less
    if (N <= 64)
      err = launch_wgmma<64>(x, w, shift, y, part1, part2, M, K, N, sms, stream);
    else if (N <= 128 || wgmma_tiles(M, N, 256) <= 3LL * sms)
      err = launch_wgmma<128>(x, w, shift, y, part1, part2, M, K, N, sms, stream);
    else
      err = launch_wgmma<256>(x, w, shift, y, part1, part2, M, K, N, sms, stream);
  } else {
    const dim3 grid(blocks, (unsigned)((N + kBN - 1) / kBN));
    conv_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), shift, static_cast<T*>(y), part1,
        part2, M, K, N, aligned);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const dim3 sum_block(kSumThreadsX, kSumThreadsY);
  column_sums_kernel<<<(unsigned)((N + kSumThreadsX - 1) / kSumThreadsX), sum_block, 0,
                       stream>>>(part1, part2, s1, s2, (int)blocks, N);
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
