// Causal (or full) flash attention forward for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, launched by `_flash_fwd` in
// pytorch_distributed_training_example_tpu/ops/flash_attention.py: an
// online-softmax attention forward that never writes the S x S score matrix
// to device memory, skips key tiles above the causal diagonal, masks inside
// the diagonal tile, and emits the per-row log-sum-exp for the backward.
//
// What bounds it on this card: tensor-core operations. Causal attention does
// 2 * B * H * S^2 * D flops (QK^T and PV, half the square each) on
// 4 * B * H * S * D bytes of q, k, v and out, i.e. ~S/2 flops per byte, far
// above the H100's ~295 flop/byte balance point at S >= 1024; the least time
// is the flops over the 989 TF/s bf16 dense peak.
//
// What the design does about it, in this first version:
// - One block of four warps per (64-row q tile, head, batch). It reads q, k,
//   v in their [B, S, H, D] layout and maps head h to KV head h / G, so the
//   repeated K/V of grouped-query attention is never materialised.
// - The block loops over 64-row K/V tiles only up to the diagonal (the
//   causal skip halves the work), stages each tile in shared memory with
//   16-byte loads, masks inside the diagonal tile, and writes the output
//   once, with lse [B, H, S] in fp32 for the backward.
// - bf16 runs on the tensor cores with mma.sync (16x8x16 bf16 tiles, fp32
//   accumulation) in the FlashAttention-2 register scheme: each warp owns
//   16 q rows, and the scores, the online-softmax state (max, sum) and the
//   output rows stay in registers in fp32; p is rounded to bf16 before the
//   p v product, as the TPU kernel rounds it to v's dtype.
// - fp32 keeps fp32 products (the tensor cores would round them to TF32)
//   and runs on the CUDA cores from a 4 x 8 register tile per thread.
// wgmma, TMA and a pipelined K/V ring are the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as in the JAX kernels
constexpr int kThreads = 128;      // 16 row groups x 8 column groups
constexpr int kBM = 64;            // q rows per block
constexpr int kBN = 64;            // k/v rows per tile

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

template <int D>
constexpr size_t simt_smem_bytes() {
  // q, k, v tiles with rows padded by one float (no bank conflicts on the
  // column-strided reads), plus the 64 x 64 probability tile.
  return sizeof(float) * (3 * kBM * (D + 1) + kBM * (kBN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_simt_kernel(
    const T* __restrict__ q,  // [B, Sq, H, D]
    const T* __restrict__ k,  // [B, Skv, Hkv, D]
    const T* __restrict__ v,  // [B, Skv, Hkv, D]
    T* __restrict__ out,      // [B, Sq, H, D]
    float* __restrict__ lse,  // [B, H, Sq]
    int Sq, int Skv, int H, int Hkv, int causal, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int LP = kBN + 1;
  constexpr int TR = 4;      // rows per thread: ty + 16 * i
  constexpr int TC = 8;      // score columns per thread: tx + 8 * j
  constexpr int TD = D / 8;  // output columns per thread: tx + 8 * j
  extern __shared__ float smem[];
  float* q_s = smem;             // [kBM, LD]
  float* k_s = q_s + kBM * LD;   // [kBN, LD]
  float* v_s = k_s + kBN * LD;   // [kBN, LD]
  float* p_s = v_s + kBN * LD;   // [kBM, LP]

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)Hkv * D;
  const T* q_b = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* k_b = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const T* v_b = v + (size_t)b * Skv * kv_row + (size_t)hk * D;

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    q_s[r * LD + d] =
        (q0 + r < Sq) ? to_float(q_b[(size_t)(q0 + r) * q_row + d]) : 0.f;
  }

  float m[TR], l[TR], acc[TR][TD];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Skv + kBN - 1) / kBN;
  if (causal) {
    const int last_row = min(q0 + kBM, Sq) - 1;
    n_tiles = min(n_tiles, last_row / kBN + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // q_s is loaded; the previous tile is consumed
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const bool ok = k0 + r < Skv;
      const size_t off = (size_t)(k0 + r) * kv_row + d;
      k_s[r * LD + d] = ok ? to_float(k_b[off]) : 0.f;
      v_s[r * LD + d] = ok ? to_float(v_b[off]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[TR], kb[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qa[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kb[j] = k_s[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] += qa[i] * kb[j];
    }

    // Online softmax; the 8 threads of one row are 8 neighbouring lanes.
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool valid = kp < Skv && (!causal || kp <= qp);
        s[i][j] = valid ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float corr = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float e = expf(s[i][j] - mx);
        p_s[(ty + 16 * i) * LP + tx + 8 * j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float pa[TR], vb[TD];
#pragma unroll
      for (int i = 0; i < TR; ++i) pa[i] = p_s[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) vb[j] = v_s[c * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] += pa[i] * vb[j];
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)b * Sq + qp) * q_row + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < TD; ++j) o[tx + 8 * j] = from_float<T>(acc[i][j] / denom);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + qp] = m[i] + logf(denom);
  }
}

// Tensor-core path (bf16): mma.sync m16n8k16 with fp32 accumulation, the
// FlashAttention-2 register scheme. Each warp owns 16 q rows; a lane holds
// two of them (groupID and groupID + 8, groupID = lane / 4) in the
// documented accumulator layout, so the running max, sum and output rows
// live in registers and the score accumulator is reused, rounded to bf16,
// directly as the A operand of the P V product.
template <int D>
struct MmaLayout {
  static constexpr int kLd = D + 8;  // bf16 row stride: 16-byte aligned rows
                                     // that land on distinct banks
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kBN * kLd;
  static constexpr size_t kBytes = 3 * kTileBytes;  // q, k, v tiles
  static_assert(kBM == kBN && kBM == (kThreads / 32) * 16,
                "one 16-row MMA strip per warp");
};

// Copy rows [r0, r0 + 64) of a [rows, row_stride] bf16 matrix (head column
// offset already applied) into a [64, ld] shared tile with 16-byte loads;
// rows at or past n_rows are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          size_t row_stride, int r0,
                                          int n_rows) {
  constexpr int kRowVecs = D / 8;
  static_assert(kBN * kRowVecs % kThreads == 0, "tile must split evenly");
#pragma unroll
  for (int j = 0; j < kBN * kRowVecs / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kRowVecs;
    const int c = (i - r * kRowVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) *
                                                      row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Sq, H, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Skv, Hkv, D]
    const __nv_bfloat16* __restrict__ v,  // [B, Skv, Hkv, D]
    __nv_bfloat16* __restrict__ out,      // [B, Sq, H, D]
    float* __restrict__ lse,              // [B, H, Sq]
    int Sq, int Skv, int H, int Hkv, int causal, float sm_scale) {
  using L = MmaLayout<D>;
  constexpr int kLd = L::kLd;
  constexpr int NT = kBN / 8;  // 8-key score tiles per strip
  constexpr int ND = D / 8;    // 8-column output tiles per strip
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBM * kLd;
  __nv_bfloat16* v_s = k_s + kBN * kLd;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // row within the 8-row half of the strip
  const int tig = lane & 3;   // column pair within an 8-column tile
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)Hkv * D;
  const __nv_bfloat16* k_b = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const __nv_bfloat16* v_b = v + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const int row[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  const __nv_bfloat16* q_w = q_s + warp * 16 * kLd;

  load_tile<D>(q_s, kLd, q + (size_t)b * Sq * q_row + (size_t)h * D, q_row,
               q0, Sq);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  int n_tiles = (Skv + kBN - 1) / kBN;
  if (causal) {
    const int last_row = min(q0 + kBM, Sq) - 1;
    n_tiles = min(n_tiles, last_row / kBN + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // q is staged; the previous tile is consumed
    load_tile<D>(k_s, kLd, k_b, kv_row, k0, Skv);
    load_tile<D>(v_s, kLd, v_b, kv_row, k0, Skv);
    __syncthreads();

    // S = q k^T: the strip's 16 rows against the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = q_w + gid * kLd + kk * 16 + tig * 2;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * kLd);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * kLd + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = k_s + (n * 8 + gid) * kLd + kk * 16 +
                                  tig * 2;
        mma_bf16(s[n], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }

    // Mask, scale and the online softmax; a row's 64 scores are spread over
    // the four lanes of its quad.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + tig * 2 + (e & 1);
        const int qp = row[e >> 1];
        const bool valid = kp < Skv && (!causal || kp <= qp);
        s[n][e] = valid ? s[n][e] * sm_scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // o += p v, p rounded to bf16 as the TPU kernel rounds it to v's dtype.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // Lanes 8j..8j+7 address the rows of matrix j: keys kk*16 + (j&1)*8
      // + r at output columns n*8 + (j>>1)*8.
      const __nv_bfloat16* vb = v_s +
                                (kk * 16 + (lane & 8) + (lane & 7)) * kLd +
                                ((lane >> 4) << 3);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vb + n * 8);
        mma_bf16(o[n], a0, a1, a2, a3, bv[0], bv[1]);
        mma_bf16(o[n + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / denom;
    __nv_bfloat16* o_row = out + ((size_t)b * Sq + row[i]) * q_row +
                           (size_t)h * D + tig * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o_row + n * 8) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (tig == 0) lse[((size_t)b * H + h) * Sq + row[i]] = m[i] + logf(denom);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Skv, int H, int Hkv, int causal,
               float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_simt_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_simt_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Skv, H, Hkv, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int Sq, int Skv, int H, int Hkv, int causal,
                float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = MmaLayout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Skv, H, Hkv, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Skv, int H, int Hkv, int causal, float sm_scale,
           int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal,
                         sm_scale, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal,
                          sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {64, 128, 256}. Returns the
// cudaError_t of the launch.
extern "C" int pdtx_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int Sq, int Skv,
                              int H, int Hkv, int D, int causal,
                              float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal,
                        sm_scale, dtype, s);
    case 128:
      return launch<128>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal,
                         sm_scale, dtype, s);
    case 256:
      return launch<256>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal,
                         sm_scale, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
