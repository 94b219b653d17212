// Tile machinery of the bf16 attention kernels for Hopper (sm_90a):
// flash_fwd.cu (row 7), flash_bwd.cu (rows 8-9) and short_attention.cu
// (rows 11-12) include it.
//
// One warp owns 16 query rows; a block of 4 warps (kMmaThreads) owns 64
// (kMmaRows). Operands live in shared memory as bf16 rows of `ld` elements,
// ld = dpad + 8 where dpad is d (or d_v) rounded up to a multiple of 16 and
// filled with zeros past d. The 16 bytes of padding make a row stride that
// is an odd multiple of 16 bytes, so the 8 rows an ldmatrix reads fall in
// 8 different groups of 4 banks: no bank conflicts.
//
// Products run on the tensor cores as
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (bf16 operands, exact products, fp32 sums). With lane = 4 g + c
// (g = lane / 4 in 0..7, c = lane % 4 in 0..3), the fragments are:
//   A (16 x 16, row): a[0] = (row g,     k 2c, 2c+1)   a[1] = (row g + 8, k 2c, 2c+1)
//                     a[2] = (row g,     k 2c+8, +9)   a[3] = (row g + 8, k 2c+8, +9)
//   B (16 x 8, col):  b[0] = (k 2c, 2c+1, column g)   b[1] = (k 2c+8, +9, column g)
//   C (16 x 8, f32):  c[0], c[1] = (row g,     columns 2c, 2c+1)
//                     c[2], c[3] = (row g + 8, columns 2c, 2c+1)
// So in a score tile S (16 rows x 8 keys) a thread holds query rows g and
// g + 8 of its warp's 16 and keys 2c, 2c+1 of the tile; the 4 lanes of a
// quad (same g) hold one row between them, and a row statistic is combined
// across the quad with two shuffles (quad_max, quad_sum). Two neighbouring
// score tiles (keys 16j..16j+7 and 16j+8..16j+15) are, element for element,
// the A fragment of P for the keys 16j..16j+15 of the P V product
// (scores_to_a): P stays in registers, as in FlashAttention-2.
//
// Copies: cp.async of 16 bytes from global to shared memory (stage_tile with
// VEC) where every row start is 16-byte aligned and d % 8 == 0, else plain
// element loads (VEC false) into the same layout. The launchers choose VEC
// from the pointers and strides; the kernels use two stages of K/V tiles so
// that the next tile loads while the tensor cores work on the current one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaRows = 64;      // query rows of a block, 16 a warp


__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Row stride in shared memory of a tile whose columns are padded to dpad.
__host__ __device__ constexpr int tile_ld(int dpad) { return dpad + 8; }

// True when p is 16-byte aligned.
__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// What VEC needs of one (batch, head, time, d) operand of extents (b, h, t):
// an aligned base, and strides (in bf16 elements) and
// a width d that are multiples of 8, so that every row start is 16-byte
// aligned and holds whole 16-byte chunks. The stride of an extent of 1 is
// never applied, so it may be anything.
__host__ inline bool rows_vectorizable(const void* p, const long long* strides, int b, int h,
                                       int t, int d) {
  const int sizes[3] = {b, h, t};
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && strides[i] % 8 != 0) return false;
  return aligned16(p) && d % 8 == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first src_bytes (0 or 16) are read
// and the rest filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (src 4-byte aligned), zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + n) of a (rows, d) bf16 matrix (row stride `stride`
// elements, unit column stride) into dst: n rows of ld elements, columns
// [0, dpad). Rows at or past `rows` and columns at or past d are zero. Each
// row's 16-byte chunks go to 8 neighbouring threads, 16 rows a pass (no
// integer division). VEC: one cp.async a chunk (needs rows_vectorizable);
// otherwise the chunk's 8 elements one at a time, synchronously.
template <bool VEC>
__device__ __forceinline__ void stage_tile(bf16* dst, int ld, const bf16* src, long long stride,
                                           int r0, int n, int rows, int d, int dpad) {
  for (int r = threadIdx.x >> 3; r < n; r += kMmaThreads / 8) {
    const bool row_in = r0 + r < rows;
    const bf16* srow = src + (long long)(r0 + r) * stride;
    for (int c = (threadIdx.x & 7) * 8; c < dpad; c += 64) {
      if (VEC) {
        const bool in = row_in && c < d;
        cp_async16(dst + r * ld + c, in ? srow + c : src, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[r * ld + c + e] = row_in && c + e < d ? srow[c + e] : __float2bfloat16(0.0f);
      }
    }
  }
}

// e^x as the bf16 kernels form their probabilities: ex2.approx of x log2(e)
// (one MUFU instruction; 0 at -inf). Within ~2^-21 of expf's value
// relative, for |x| up to ~30, far below the bf16 rounding of P that follows.
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// S = Q K^T for one warp: s[nt] is the C fragment of keys 8 nt .. 8 nt + 7.
// q: the warp's 16 rows (stride q_ld); k: the tile's key rows (stride k_ld);
// the sum runs over dp columns (a multiple of 16, at most DMAX). Only the
// first `pairs` pairs of key tiles are computed; the others stay 0. Q's
// fragments are read again for each key tile.
template <int NT, int DMAX>
__device__ __forceinline__ void warp_scores(float (&s)[NT][4], const bf16* q, int q_ld,
                                            const bf16* k, int k_ld, int dp, int pairs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
  // ldmatrix row addresses: A matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15);
  // B matrices (keys 0-7: k 0-7 | 8-15), (keys 8-15: k 0-7 | 8-15)
  const bf16* qa = q + (lane & 15) * q_ld + (lane >> 4) * 8;
  const bf16* kb = k + ((lane & 7) + (lane >> 4) * 8) * k_ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DMAX; kk += 16) {
    if (kk >= dp) break;
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk);
#pragma unroll
    for (int kp = 0; kp < NT / 2; ++kp) {
      if (kp >= pairs) break;
      uint32_t b[4];
      ldmatrix_x4(b, kb + kp * 16 * k_ld + kk);
      mma_bf16(s[2 * kp], a, b[0], b[1]);
      mma_bf16(s[2 * kp + 1], a, b[2], b[3]);
    }
  }
}

// The key-padding bias of the keys this thread's score fragments hold, keys
// k0 + 8 nt + 2 c + {0, 1} (0 past n): loaded before the product, so that the
// loads' latency hides behind it.
template <int NT>
__device__ __forceinline__ void load_bias(float (&bv)[NT][2], const float* bias, int k0, int n) {
  const int key0 = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = key0 + nt * 8 + c;
      bv[nt][c] = key < n ? bias[key] : 0.0f;
    }
}

// The A fragments of P (rounded to bf16) for keys 16 kp .. 16 kp + 15 from
// the score fragments of key tiles 2 kp and 2 kp + 1.
template <int NT>
__device__ __forceinline__ void scores_to_a(uint32_t (&pa)[NT / 2][4], const float (&p)[NT][4]) {
#pragma unroll
  for (int kp = 0; kp < NT / 2; ++kp) {
    pa[kp][0] = pack_bf16(p[2 * kp][0], p[2 * kp][1]);
    pa[kp][1] = pack_bf16(p[2 * kp][2], p[2 * kp][3]);
    pa[kp][2] = pack_bf16(p[2 * kp + 1][0], p[2 * kp + 1][1]);
    pa[kp][3] = pack_bf16(p[2 * kp + 1][2], p[2 * kp + 1][3]);
  }
}

// o += P V for one warp: o[nv] is the C fragment of value columns
// 8 nv .. 8 nv + 7; v: the tile's key rows (stride v_ld), dvp columns (a
// multiple of 16, at most 8 NV). Only the first `pairs` 16-key steps run.
template <int NT, int NV>
__device__ __forceinline__ void warp_pv(float (&o)[NV][4], const uint32_t (&pa)[NT / 2][4],
                                        const bf16* v, int v_ld, int dvp, int pairs) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.trans row addresses: (keys 0-7 | 8-15) x (columns 0-7 | 8-15)
  const bf16* vb = v + ((lane & 7) + ((lane >> 3) & 1) * 8) * v_ld + (lane >> 4) * 8;
#pragma unroll
  for (int kp = 0; kp < NT / 2; ++kp) {
    if (kp >= pairs) break;
#pragma unroll
    for (int np = 0; np < NV / 2; ++np) {
      if (np * 16 >= dvp) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, vb + kp * 16 * v_ld + np * 16);
      mma_bf16(o[2 * np], pa[kp], b[0], b[1]);
      mma_bf16(o[2 * np + 1], pa[kp], b[2], b[3]);
    }
  }
}

// Stores a warp's 16 x (8 NV) fragments of o, each value divided by the
// divisor of its row (div[0] for row g, div[1] for row g + 8), as bf16 into
// rows row0 + g and row0 + g + 8 (those below `rows`), columns below dv.
// VEC: dv is even and rows are 4-byte aligned, so a thread writes its two
// columns as one 4-byte store.
template <int NV, bool VEC>
__device__ __forceinline__ void store_rows(bf16* out, long long stride, int row0, int rows,
                                           int dv, const float (&o)[NV][4],
                                           const float (&div)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= rows) continue;
    bf16* dst = out + (long long)row * stride;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const int col = nv * 8 + c2;
      if (col >= dv) break;
      const float x0 = o[nv][2 * h] / div[h], x1 = o[nv][2 * h + 1] / div[h];
      if (VEC) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[col] = __float2bfloat16(x0);
        if (col + 1 < dv) dst[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

}  // namespace attn_mma
