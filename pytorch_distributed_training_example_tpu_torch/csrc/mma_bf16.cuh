// Helpers shared by the tensor-core kernels (flash_fwd.cu, flash_bwd.cu,
// grouped_matmul.cu, fused_bn_matmul.cu, paged_decode.cu): dtype
// conversion, 16-byte tile staging into shared memory (plain and cp.async),
// ex2, and the mma.sync m16n8k16 bf16 fragments of the FlashAttention-2
// register scheme.
//
// Fragment layout of one 16x8x16 product (PTX ISA, "mma.m16n8k16"), with
// gid = lane / 4 and tig = lane % 4:
// - A (16 x 16, row major): a0 = A[gid][2tig..], a1 = A[gid+8][2tig..],
//   a2 = A[gid][2tig+8..], a3 = A[gid+8][2tig+8..];
// - B (16 x 8): b0 = B[2tig..][gid], b1 = B[2tig+8..][gid]; when B is
//   stored transposed (n rows of k values) these are two 32-bit loads;
// - C (16 x 8, fp32): c0, c1 = C[gid][2tig, 2tig+1], c2, c3 = C[gid+8][..].
// An accumulator of 16 x 16 (two C tiles side by side) is therefore already
// the A fragment of the next product once rounded to bf16 (pack_bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pdtx {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy rows [r0, r0 + ROWS) of a [rows, row_stride] bf16 matrix (head column
// offset already applied) into a [ROWS, ld] shared tile with 16-byte loads;
// rows at or past n_rows are zero.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          size_t row_stride, int r0,
                                          int n_rows) {
  constexpr int kRowVecs = D / 8;
  static_assert(ROWS * kRowVecs % THREADS == 0, "tile must split evenly");
#pragma unroll
  for (int j = 0; j < ROWS * kRowVecs / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / kRowVecs;
    const int c = (i - r * kRowVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) *
                                                      row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The same for fp32 into a [ROWS, ld] float tile (ld = D + 1 keeps the
// column-strided reads of the CUDA-core kernels on distinct banks).
template <int ROWS, int D, int THREADS, typename T>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const T* src,
                                              size_t row_stride, int r0,
                                              int n_rows) {
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * ld + d] =
        (r0 + r < n_rows) ? to_float(src[(size_t)(r0 + r) * row_stride + d])
                          : 0.f;
  }
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// `valid` is false (src then only has to be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// An 8x8 bf16 matrix in the fragment layout (lane l holds row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1), transposed in registers.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// c += a b for one 16x8x16 bf16 tile, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory as stored, lanes 8j..8j+7
// addressing the rows of matrix j: over a row-major [m][k] tile they are
// the A fragment of a 16x8x16 product (matrices: rows 0-7 and 8-15 at k
// 0-7, then at k 8-15).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Four 8x8 bf16 matrices from shared memory, transposed: the B operands of
// two 16x8x16 products whose K dimension runs down the stored rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The lane's row address for ldmatrix_x4_trans over a row-major [k][n]
// shared matrix at k rows k0..k0+15: lanes 8j..8j+7 address the rows of
// matrix j (k0 + (j & 1) * 8 + r, columns + (j >> 1) * 8), so the four
// results are b0, b1 of n-tile n and b0, b1 of n-tile n + 1.
__device__ __forceinline__ const __nv_bfloat16* trans_rows(
    const __nv_bfloat16* base, int ld, int k0, int lane) {
  return base + (k0 + (lane & 8) + (lane & 7)) * ld + ((lane >> 4) << 3);
}

// The A fragment of rows [0, 16) x columns [kk*16, kk*16 + 16) of a
// row-major bf16 shared strip.
struct AFrag {
  uint32_t a0, a1, a2, a3;
};
__device__ __forceinline__ AFrag load_a(const __nv_bfloat16* strip, int ld,
                                        int kk, int gid, int tig) {
  const __nv_bfloat16* p = strip + gid * ld + kk * 16 + tig * 2;
  return {ld32(p), ld32(p + 8 * ld), ld32(p + 8), ld32(p + 8 * ld + 8)};
}

// The A fragment of k-step kk from a 16 x (16 * n) fp32 accumulator, rounded
// to bf16.
template <int NT>
__device__ __forceinline__ AFrag pack_a(const float (&c)[NT][4], int kk) {
  return {pack_bf16(c[2 * kk][0], c[2 * kk][1]),
          pack_bf16(c[2 * kk][2], c[2 * kk][3]),
          pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
          pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
}

__device__ __forceinline__ void mma_tile(float (&c)[4], const AFrag& a,
                                         uint32_t b0, uint32_t b1) {
  mma_bf16(c, a.a0, a.a1, a.a2, a.a3, b0, b1);
}

}  // namespace pdtx
