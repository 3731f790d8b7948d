// Causal (or full) flash attention forward for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces three Pallas TPU kernels of
// pytorch_distributed_training_example_tpu/ops/flash_attention.py:
// - `_fwd_kernel` (launched by `_flash_fwd`): an online-softmax attention
//   forward that never writes the S x S score matrix to device memory,
//   skips key tiles above the causal diagonal, masks inside the diagonal
//   tile, and emits the per-row log-sum-exp for the backward;
// - `_oneshot_fwd_kernel` (launched by `_oneshot_fwd`): the same function
//   with keys at or past `kv_len` masked (`_kv_len_mask`), causal or not,
//   GQA through h / G. It serves the padded path (ViT's 197 tokens padded
//   to 256). Where the TPU kernel scores every padded key and masks it,
//   this one stops at kv_len: key tiles wholly past it are never loaded,
//   and only the tile that straddles it is masked;
// - `_oneshot_fwd_kernel_chunked`: the causal forward with key chunks above
//   the diagonal skipped, which is the causal contract above.
// The contract of all three: the diagonal masked q_pos >= k_pos (positions
// from 0 for q and k), keys at or past kv_len masked (padded query rows
// attend to the first kv_len keys, so their lse stays finite), head h
// reading K/V head h / G, p rounded to bf16 before P V with fp32 softmax
// state, out = acc / max(l, 1e-30) in q's dtype and lse = m + log(max(l,
// 1e-30)), a natural log, fp32 [B, H, Sq].
//
// What bounds it on this card: causal attention does 2 * B * H * S^2 * D
// flops (QK^T and PV, half the square each) on 4 * B * H * S * D bytes of
// q, k, v and out, ~S/2 flops per byte, far above the H100's ~295
// flop/byte balance point at S >= 1024: the tensor cores, 989 TF/s bf16.
// Inside a tile, at head_dim 64, the online softmax (one ex2 a score on
// the SM's quarter-rate XU pipe) takes longer than the products; at 128
// the products take the larger share.
//
// What the design does about it:
// - bf16 at head_dim 64 and 128 (every model's path) runs on wgmma
//   (hopper.cuh), FlashAttention-3's scheme. A block is two consumer
//   warpgroups of 64 q rows each and one producer warpgroup (setmaxnreg
//   moves its registers to the consumers), persistent: one block an SM
//   walks over (128-row q tile, head, batch) work items, the heaviest
//   causal q tiles first in a snake order over the blocks, the G query
//   heads of one KV head adjacent so their K/V tiles meet in L2.
// - Copies: the producer brings each work item's Q in by TMA once, and
//   the K and V tiles of 128 keys through a ring of shared-memory stages
//   (full/empty mbarriers), only up to the diagonal and up to kv_len, so
//   copies overlap the products and the next work item's loads overlap
//   this one's last tile and stores.
// - Products: S = Q K^T is wgmma from shared memory, both operands K-major
//   in the 128-byte-swizzled tiles; P stays in the accumulator layout and,
//   rounded to bf16, is the register A operand of O += P V, V read MN-major
//   from the same tile. A tile's S is issued together with the previous
//   tile's P V and waited for first, so the softmax runs while P V does
//   (FlashAttention-3's overlap inside a warpgroup).
// - Softmax: scale and log2(e) folded into one FFMA before ex2, one ex2 a
//   score and one a row correction; the row max is converted to the
//   natural-log lse at the end. Only the tiles that cross the diagonal or
//   kv_len are masked, decided from positions.
// - bf16 at head_dim 256 (no model uses it) keeps mma.sync m16n8k16 in the
//   FlashAttention-2 register scheme: each warp owns 16 q rows, four warps
//   a 64-row block, K/V tiles of 64 staged with 16-byte loads.
// - fp32 keeps fp32 products (the tensor cores would round them to TF32)
//   and runs on the CUDA cores from a 4 x 8 register tile per thread.

#include <math.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite, as in the JAX kernels
constexpr int kThreads = 128;      // 16 row groups x 8 column groups
constexpr int kBM = 64;            // q rows per block
constexpr int kBN = 64;            // k/v rows per tile

using namespace pdtx;

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
    int Sq, int Skv, int kv_len, int H, int Hkv, int causal,
    float sm_scale) {
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

  // Keys at or past kv_len (<= Skv) are padding: never loaded, masked.
  int n_tiles = (kv_len + kBN - 1) / kBN;
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
      const bool ok = k0 + r < kv_len;
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
        const bool valid = kp < kv_len && (!causal || kp <= qp);
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

// bf16 at head_dim 256: mma.sync m16n8k16 with fp32 accumulation, the
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Sq, H, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Skv, Hkv, D]
    const __nv_bfloat16* __restrict__ v,  // [B, Skv, Hkv, D]
    __nv_bfloat16* __restrict__ out,      // [B, Sq, H, D]
    float* __restrict__ lse,              // [B, H, Sq]
    int Sq, int Skv, int kv_len, int H, int Hkv, int causal,
    float sm_scale) {
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

  load_tile<kBM, D, kThreads>(
      q_s, kLd, q + (size_t)b * Sq * q_row + (size_t)h * D, q_row, q0, Sq);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  // Keys at or past kv_len (<= Skv) are padding: tiles past it are never
  // loaded, and the one that straddles it reads zeros there.
  int n_tiles = (kv_len + kBN - 1) / kBN;
  if (causal) {
    const int last_row = min(q0 + kBM, Sq) - 1;
    n_tiles = min(n_tiles, last_row / kBN + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBN;
    const int k_live = kv_len - k0;  // keys of this tile before kv_len
    __syncthreads();  // q is staged; the previous tile is consumed
    load_tile<kBN, D, kThreads>(k_s, kLd, k_b, kv_row, k0, kv_len);
    load_tile<kBN, D, kThreads>(v_s, kLd, v_b, kv_row, k0, kv_len);
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
        if (n * 8 < k_live) {  // 8-key tiles past kv_len stay masked
          const __nv_bfloat16* kb = k_s + (n * 8 + gid) * kLd + kk * 16 +
                                    tig * 2;
          mma_bf16(s[n], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
        }
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
        const bool valid = kp < kv_len && (!causal || kp <= qp);
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
      if (kk * 16 >= k_live) continue;  // p is zero past kv_len
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

// ---------------------------------------------------------------------------
// bf16 at head_dim 64 and 128: wgmma fed by a TMA ring, warp-specialised
// ---------------------------------------------------------------------------
//
// A block is kConsumers consumer warpgroups and one producer warpgroup,
// one block an SM, persistent. A work item is a q tile of 64 kConsumers
// rows of one (head, batch): consumer warpgroup w owns its rows
// q0 + 64w..q0 + 64w + 63 and takes the key tiles up to its own diagonal
// and its rows' end; past them it only waits for each stage and frees it,
// so the ring stays in step (the producer loads up to the last
// warpgroup's diagonal). The producer waits for the Q buffer's `q_empty`
// barrier (one arrival per consumer warp, after its last S product) before
// it loads the next item's Q, and for a stage's `empty` barrier before it
// refills that stage with K and V (the consumers wait on `full`: the
// producer's arrival and the TMA bytes). Stage and phase are counted
// across work items, the same way on both sides.

using bf16 = __nv_bfloat16;

template <int D>
struct WgCfg {
  // Consumer warpgroups. Three at head_dim 64 (a 192-row q tile, 160
  // registers a thread) ran 0.94-1.03x the time of two: the softmax, on
  // the XU pipe, takes longer a tile when three warps share a
  // sub-partition's, and a ragged last q tile idles more rows
  // (bench/flash_fwd_phases.py --variants).
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer
  // Registers a thread after the split: the producer warpgroup gives its
  // back (one thread of it issues the copies, the rest exit), the consumers
  // take them: 40 * 128 + 232 * 256 of the SM's 65,536.
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr int kBM = 64 * kConsumers;  // q rows a work item
  static constexpr int kBN = 128;              // keys a stage
  // Ring depth: 3 x 64 KB at head_dim 128 (2 stages ran 1.3x slower),
  // 4 x 32 KB at 64 (bench/flash_fwd_phases.py --variants).
  static constexpr int kStages = D > 64 ? 3 : 4;
  static constexpr uint32_t kQBytes = kBM * D * sizeof(bf16);
  static constexpr uint32_t kTileBytes = kBN * D * sizeof(bf16);  // K or V
  static constexpr size_t kSmem = 1024 + kQBytes +
                                  2 * kStages * kTileBytes +
                                  sizeof(uint64_t) * (2 * kStages + 2);
  static_assert(kBN == 128 && kBM % 64 == 0, "a warpgroup's last key "
                "tile starts at or before its first row, so every row sees "
                "key k0 of each tile it takes (no all-masked tile row)");
};

struct FwdArgs {
  bf16* out;   // [B, Sq, H, D]
  float* lse;  // [B, H, Sq]
  int B, Sq, Skv, kv_len, H, Hkv, causal;
  float sm_scale;
};

// Work item w: its batch, head, KV head, first q row, and the key tiles it
// takes (up to the diagonal and kv_len). Items run heaviest q tile first
// (causal), then batch-major, the G heads of one KV head adjacent.
template <int D>
struct FwdWork {
  int q0, h, b, hk, n_tiles;
  __device__ __forceinline__ FwdWork(const FwdArgs& a, int w) {
    constexpr int kBM = WgCfg<D>::kBM, kBN = WgCfg<D>::kBN;
    const int n_qt = (a.Sq + kBM - 1) / kBM;
    const int n_bh = a.B * a.H;
    const int r = w / n_bh, bh = w % n_bh;
    q0 = (a.causal ? n_qt - 1 - r : r) * kBM;
    h = bh % a.H;
    b = bh / a.H;
    hk = h / (a.H / a.Hkv);
    const int keys = a.causal ? min(a.kv_len, min(q0 + kBM, a.Sq))
                              : a.kv_len;
    n_tiles = (keys + kBN - 1) / kBN;
  }
};

// The online softmax of one score tile (keys k0..k0 + kBN - 1) for the
// thread's rows row[0], row[1] of the warpgroup starting at qw0: scores
// masked only where the tile crosses the diagonal or kv_len, p =
// 2^(s scale log2 e - m scale log2 e) in place of s, the running max m
// (raw scores) and per-thread partial sum l, the rows' correction factor.
template <int kBN>
__device__ __forceinline__ void online_softmax(
    float (&sc)[kBN / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    int k0, int qw0, const int (&row)[2], int tig, int kvl, int causal,
    float scale_log2) {
  const bool edge = (causal && k0 + kBN - 1 > qw0) || k0 + kBN > kvl;
  if (edge) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + tig * 2 + (e & 1);
        if (kp >= kvl || (causal && kp > row[e >> 1]))
          sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  float neg[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // A row with no visible key yet keeps p = 0 (never NaN).
    const float mu = mx[i] == -INFINITY ? 0.f : mx[i];
    corr[i] = exp2_approx((m[i] - mu) * scale_log2);
    neg[i] = -mu * scale_log2;
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(sc[4 * j + e], scale_log2, neg[e >> 1]));
      sc[4 * j + e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

template <int D>
__global__ void __launch_bounds__(WgCfg<D>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const FwdArgs a) {
  using C = WgCfg<D>;
  constexpr int kBM = C::kBM, kBN = C::kBN, kStages = C::kStages;
  constexpr int kConsumers = C::kConsumers;
  constexpr uint32_t kTileBytes = C::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(align_1024(smem_raw));  // [R][kBM][64]
  bf16* k_s = q_s + kBM * D;             // [stage][R][kBN][64]
  bf16* v_s = k_s + kStages * kBN * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * kBN * D);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 1;
  const int n_work = (a.Sq + kBM - 1) / kBM * a.B * a.H;
  const int n_rounds = (n_work + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * 4);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers * 4) {  // the producer warpgroup
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp != kConsumers * 4 || lane != 0) return;
    int it = 0, n = 0;  // stage counter and work counter, as the consumers'
    for (int r = 0; r < n_rounds; ++r) {
      const int w = work_of(r);
      if (w >= n_work) continue;
      const FwdWork<D> wk(a, w);
      mbar_wait(q_empty, (n & 1) ^ 1);
      mbar_arrive_expect_tx(q_full, C::kQBytes);
      tma_load_tile<D>(q_s, &map_q, q_full, kBM, wk.h, wk.q0, wk.b);
      ++n;
      for (int t = 0; t < wk.n_tiles; ++t, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_tile<D>(k_s + s * kBN * D, &map_k, &full[s], kBN, wk.hk,
                         t * kBN, wk.b);
        tma_load_tile<D>(v_s + s * kBN * D, &map_v, &full[s], kBN, wk.hk,
                         t * kBN, wk.b);
      }
    }
    return;
  }
  setmaxnreg_inc<C::kConsumerRegs>();

  const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
  const float scale_log2 = a.sm_scale * kLog2e;
  // Shared addresses of the warpgroup's rows of Q (A of S, K-major) and of
  // the ring's K tiles (B of S, K-major) and V tiles (B of P V, MN-major),
  // as offsets from the base.
  const uint32_t base = smem_u32(q_s);
  const uint32_t q_off = 64 * wg * 64 * sizeof(bf16);
  constexpr uint32_t k_off = kBM * D * sizeof(bf16);
  constexpr uint32_t v_off = k_off + kStages * kTileBytes;
  // Key tiles 0..n_wg - 1 of work item wk for the warpgroup's rows from
  // qw0: the online-softmax attention, then out and lse. `it` counts the
  // ring's stages.
  auto attend = [&](const FwdWork<D>& wk, int qw0, int n_wg, int& it) {
    const int row[2] = {qw0 + (warp % 4) * 16 + gid,
                        qw0 + (warp % 4) * 16 + gid + 8};
    float o[D / 2], sc[kBN / 2], corr[2];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t p[kBN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    // S = Q K^T for the warpgroup's 64 rows against stage s's keys.
    auto issue_s = [&](int s) {
      const uint32_t sb = opaque(base);
      const uint64_t qd = kmajor_desc(sb + q_off);
      const uint64_t kd = kmajor_desc(sb + k_off + s * kTileBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBN>(sc, qd + kmajor_step(kBM, kk),
                      kd + kmajor_step(kBN, kk), kk > 0);
      wgmma_commit();
    };
    // O += P V, V of stage s.
    auto issue_pv = [&](int s) {
      const uint64_t vd =
          mnmajor_desc(opaque(base) + v_off + s * kTileBytes, kBN);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D>(o, p[kk], vd + mnmajor_step(kk), 1);
      wgmma_commit();
    };

    int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    wgmma_fence();
    issue_s(s);
    wgmma_wait<0>();
    reg_fence(sc);
    if (n_wg == 1) warp_arrive(q_empty, lane);
    online_softmax<kBN>(sc, m, l, corr, 0, qw0, row, tig, a.kv_len,
                        a.causal, scale_log2);
    to_a_frags<kBN>(sc, p);
    for (int t = 1; t < n_wg; ++t) {
      // This tile's S goes in with the previous tile's P V; S is waited
      // for first, and its exponentials run while P V does.
      const int s_prev = s;
      ++it;
      s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      reg_fence(p);
      reg_fence(o);
      wgmma_fence();
      issue_s(s);
      issue_pv(s_prev);
      wgmma_wait<1>();
      reg_fence(sc);
      if (t == n_wg - 1) warp_arrive(q_empty, lane);
      online_softmax<kBN>(sc, m, l, corr, t * kBN, qw0, row, tig, a.kv_len,
                          a.causal, scale_log2);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(p);
      warp_arrive(&empty[s_prev], lane);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
      to_a_frags<kBN>(sc, p);
    }
    reg_fence(p);
    reg_fence(o);
    wgmma_fence();
    issue_pv(s);
    wgmma_wait<0>();
    reg_fence(o);
    warp_arrive(&empty[s], lane);
    ++it;

    // out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)), natural.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float denom = fmaxf(l[i], 1e-30f);
      inv[i] = 1.f / denom;
      const float mu = m[i] == -INFINITY ? 0.f : m[i];
      if (tig == 0 && row[i] < a.Sq)
        a.lse[((size_t)wk.b * a.H + wk.h) * a.Sq + row[i]] =
            mu * a.sm_scale + logf(denom);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= inv[e >> 1];
    store_rows<D>(a.out + (size_t)wk.b * a.Sq * a.H * D + (size_t)wk.h * D,
                  (size_t)a.H * D, row, a.Sq, tig, o);
  };
  int it = 0, n = 0;
  for (int r = 0; r < n_rounds; ++r) {
    const int w = work_of(r);
    if (w >= n_work) continue;
    const FwdWork<D> wk(a, w);
    const int qw0 = wk.q0 + 64 * wg;  // the warpgroup's first row
    // The key tiles this warpgroup takes: none past the rows' end, up to
    // its own diagonal (causal), up to kv_len.
    const int keys = a.causal ? min(a.kv_len, min(qw0 + 64, a.Sq))
                              : a.kv_len;
    const int n_wg = qw0 >= a.Sq ? 0 : (keys + kBN - 1) / kBN;
    mbar_wait(q_full, n & 1);
    if (n_wg > 0)
      attend(wk, qw0, n_wg, it);
    else
      warp_arrive(q_empty, lane);
    // The block's tiles past this warpgroup's last: wait, then free.
    for (int t = n_wg; t < wk.n_tiles; ++t, ++it) {
      mbar_wait(&full[it % kStages], (it / kStages) & 1);
      warp_arrive(&empty[it % kStages], lane);
    }
    ++n;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Skv, int kv_len, int H, int Hkv,
               int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_simt_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_simt_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Skv, kv_len, H, Hkv, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int Sq, int Skv, int kv_len, int H, int Hkv,
                int causal, float sm_scale, cudaStream_t stream) {
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
      static_cast<float*>(lse), Sq, Skv, kv_len, H, Hkv, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

// The wgmma kernel: TMA maps of q (128-row boxes) and k, v (kBN-row
// boxes), then one persistent block an SM, or one a work item where there
// are fewer.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 void* lse, int B, int Sq, int Skv, int kv_len, int H,
                 int Hkv, int causal, float sm_scale, cudaStream_t stream) {
  using C = WgCfg<D>;
  CUtensorMap map_q, map_k, map_v;
  int err = encode_bshd_map(&map_q, q, B, Sq, H, D, C::kBM);
  if (!err) err = encode_bshd_map(&map_k, k, B, Skv, Hkv, D, C::kBN);
  if (!err) err = encode_bshd_map(&map_v, v, B, Skv, Hkv, D, C::kBN);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const long long n_work = (long long)((Sq + C::kBM - 1) / C::kBM) * B * H;
  const unsigned grid = (unsigned)(n_work < sms ? n_work : sms);
  const FwdArgs a{static_cast<bf16*>(out), static_cast<float*>(lse), B, Sq,
                  Skv, kv_len, H, Hkv, causal, sm_scale};
  flash_fwd_wgmma_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      map_q, map_k, map_v, a);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Skv, int kv_len, int H, int Hkv, int causal,
           float sm_scale, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, lse, B, Sq, Skv, kv_len, H, Hkv,
                         causal, sm_scale, stream);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if constexpr (D <= 128)
    return launch_wgmma<D>(q, k, v, out, lse, B, Sq, Skv, kv_len, H, Hkv,
                           causal, sm_scale, stream);
  else
    return launch_bf16<D>(q, k, v, out, lse, B, Sq, Skv, kv_len, H, Hkv,
                          causal, sm_scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {64, 128, 256}. Keys at or past
// kv_len (1 <= kv_len <= Skv; Skv for none) are masked. bf16 at D 64 and
// 128 runs the wgmma kernel, bf16 at D 256 the mma.sync one, fp32 the
// CUDA-core one. Returns the cudaError_t of the launch.
extern "C" int pdtx_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int Sq, int Skv,
                              int kv_len, int H, int Hkv, int D, int causal,
                              float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_len < 1 || kv_len > Skv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, lse, B, Sq, Skv, kv_len, H, Hkv,
                        causal, sm_scale, dtype, s);
    case 128:
      return launch<128>(q, k, v, out, lse, B, Sq, Skv, kv_len, H, Hkv,
                         causal, sm_scale, dtype, s);
    case 256:
      return launch<256>(q, k, v, out, lse, B, Sq, Skv, kv_len, H, Hkv,
                         causal, sm_scale, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
