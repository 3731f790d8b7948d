// Flash attention backward for Hopper (sm_90a), plain C interface for
// ctypes: dq, dk and dv from q, k, v, do, the forward's per-row log-sum-exp
// and delta = rowsum(do * o).
//
// Replaces the five Pallas TPU backward bodies of
// pytorch_distributed_training_example_tpu/ops/flash_attention.py, which
// all compute this one function and differ only in how they fit VMEM:
// `_dq_kernel` and `_dkv_kernel` (via `_flash_bwd`), `_oneshot_bwd_kernel`
// and `_oneshot_bwd_kernel_chunked` (via `_oneshot_bwd`), and
// `_stream_bwd_kernel` (via `_stream_bwd`). Their contracts are kept: causal
// or not (tiles above the diagonal skipped, the diagonal masked
// q_pos >= k_pos), keys at or past `kv_len` masked (the padded one-shot
// path), grouped-query heads folded onto their shared K/V head, p rounded to
// do's dtype before dV and ds to k's dtype before dQ and dK, fp16 computed
// in fp32 by the caller.
//
// What bounds it on this card: tensor-core operations. The function needs
// five S^2-sized products (S = q k^T, dP = do v^T, then dV, dQ, dK),
// 5 * 2 * B * H * D flops per visible (query, key) pair, on about
// 8 * B * H * S * D bytes of q, k, v, o, do, dq, dk, dv: at the GPT-2
// training shape (B=16, H=12, S=1024, D=64, causal) 6.4e10 flops against
// 0.2 GB, ~65 us at the 989 TF/s bf16 peak against ~60 us at 3.35 TB/s.
// Without atomics, S and dP are recomputed in a second pass: 7 products,
// ~91 us at that shape.
//
// What the design does about it (FlashAttention-2's two passes; blocks run
// in parallel here, so nothing carries from one block to the next as the
// TPU grid carries its VMEM sums):
// - A pre-pass kernel reads o and do once and writes delta = rowsum(do o)
//   in fp32 [B, H, Sq].
// - Both passes recompute P = exp(s * scale - lse) from the forward's lse,
//   so no S x S matrix touches device memory.
// - The dq pass takes one block per (q tile, head, batch) and loops over
//   the key tiles up to the diagonal, accumulating dq in fp32 registers.
// - The dk/dv pass takes one block per (key tile, KV head, batch) and loops
//   over the G query heads of that KV head and over their q tiles from the
//   diagonal on, accumulating dk and dv in fp32 registers. The GQA fold
//   happens inside the block: no repeated K/V, no atomics, and the result
//   is bitwise reproducible.
// - bf16 at head_dim 64 and 128 (every model's path) runs on wgmma
//   (hopper.cuh). A block is two consumer warpgroups of 64 rows and one
//   producer warpgroup (setmaxnreg moves its registers to the consumers).
//   The block's own rows (q and do for dq, k and v for dk/dv) come in once
//   by TMA; the streamed tiles (k and v; q, do, lse and delta) come
//   through a ring of 4 shared-memory stages that the producer keeps full
//   by TMA, synchronised by mbarriers, so copies overlap the products. S
//   and dP (S^T and dP^T in the dk/dv pass) are wgmma from shared memory;
//   P and dS stay in registers and, rounded to bf16, are the register A
//   operand of dV, dK and dQ, whose B (do, q, k) is read MN-major from the
//   same swizzled tiles. Causal passes skip the tiles above the diagonal
//   and mask only the tiles that cross it; the heaviest blocks (first key
//   tiles, last q tiles) are launched first, so the last wave is short.
//   Every wgmma kernel is held to 0 spill bytes: at head_dim 128 the dq
//   pass streams 32-key tiles, and in the dk/dv pass both consumer
//   warpgroups take the same 64 keys and each accumulates one 64-column
//   half of dk and dv (s and dp computed twice: 6 products a tile instead
//   of 4, but a warpgroup that held all 128 columns spilled and serialised
//   its wgmma).
// - bf16 at head_dim 256 (no model uses it) keeps mma.sync m16n8k16 in the
//   forward's register scheme (mma_bf16.cuh), four warps a block, and runs
//   two column halves of 128, each recomputing the scores.
// - fp32 keeps exact fp32 products on the CUDA cores (the tensor cores would
//   round them to TF32), as the forward's fp32 path does.

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace pdtx;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // finite, as in the JAX kernels
constexpr int kThreads = 128;      // four warps
constexpr int kRows = 64;          // rows a block owns: q (dq) or keys (dkv)

struct Args {
  const void* q;      // [B, Sq, H, D]
  const void* k;      // [B, Skv, Hkv, D]
  const void* v;      // [B, Skv, Hkv, D]
  const void* dout;   // [B, Sq, H, D]
  const float* lse;   // [B, H, Sq]
  const float* delta; // [B, H, Sq]
  void* dq;           // [B, Sq, H, D]
  void* dk;           // [B, Skv, Hkv, D]
  void* dv;           // [B, Skv, Hkv, D]
  int Sq, Skv, H, Hkv, causal, kv_len;
  float sm_scale;
};

template <int D>
struct Cfg {
  static constexpr int kOut = D > 128 ? 128 : D;  // output columns per block
  static constexpr int kSplit = D / kOut;         // column blocks per head
  // bf16 tensor-core kernels
  static constexpr int kLd = D + 8;  // bf16 row stride: 16-byte aligned rows
                                     // that land on distinct banks
  static constexpr int kKeys = 64;                // keys per dq step
  static constexpr int kQ = 32;                   // queries per dkv step
  static constexpr size_t kDqBytes = sizeof(bf16) * (2 * kRows + 2 * kKeys) *
                                     kLd;
  static constexpr size_t kDkvBytes =
      sizeof(bf16) * (2 * kRows + 2 * kQ) * kLd + 2 * sizeof(float) * kQ;
  // fp32 CUDA-core kernels: 16 x 8 threads, 4 rows x (4 score / kOut/8
  // output) columns each; 32 keys or queries per step.
  static constexpr int kLdF = D + 1;
  static constexpr int kStep = 32;
  static constexpr int kLp = kStep + 1;
  static constexpr size_t kDqBytesF =
      sizeof(float) * ((2 * kRows + 2 * kStep) * kLdF + kRows * kLp);
  static constexpr size_t kDkvBytesF =
      sizeof(float) * ((2 * kRows + 2 * kStep) * kLdF + 2 * kRows * kLp +
                       2 * kStep);
};

// p = exp(s * scale - lse) with the masks of the JAX kernels: a masked score
// is NEG_INF before the exp; a row or key outside the arrays contributes 0.
__device__ __forceinline__ float prob(float s, float lse, int qp, int kp,
                                      const Args& a) {
  if (qp >= a.Sq || kp >= a.Skv) return 0.f;
  const bool keep = kp < a.kv_len && (!a.causal || kp <= qp);
  return expf((keep ? s * a.sm_scale : kNegInf) - lse);
}

// ---------------------------------------------------------------------------
// bf16 at head_dim 256: mma.sync tensor cores
// ---------------------------------------------------------------------------

// dq = sum over key tiles of ds k, ds = p (dp - delta) scale, one block per
// (64-row q tile, head and column half, batch).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kKeys = C::kKeys, kOut = C::kOut;
  constexpr int NS = kKeys / 8;  // 8-key score tiles per strip
  constexpr int NO = kOut / 8;   // 8-column output tiles per strip
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kRows, kLd]
  bf16* do_s = q_s + kRows * kLd;                 // [kRows, kLd]
  bf16* k_s = do_s + kRows * kLd;                 // [kKeys, kLd]
  bf16* v_s = k_s + kKeys * kLd;                  // [kKeys, kLd]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y / C::kSplit;
  const int c0 = (blockIdx.y % C::kSplit) * kOut;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const size_t q_row = (size_t)a.H * D, kv_row = (size_t)a.Hkv * D;
  const size_t q_off = (size_t)b * a.Sq * q_row + (size_t)h * D;
  const size_t kv_off = (size_t)b * a.Skv * kv_row + (size_t)hk * D;
  const bf16* k_b = static_cast<const bf16*>(a.k) + kv_off;
  const bf16* v_b = static_cast<const bf16*>(a.v) + kv_off;

  load_tile<kRows, D, kThreads>(q_s, kLd, static_cast<const bf16*>(a.q) +
                                q_off, q_row, q0, a.Sq);
  load_tile<kRows, D, kThreads>(do_s, kLd, static_cast<const bf16*>(a.dout) +
                                q_off, q_row, q0, a.Sq);
  const int row[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = ((size_t)b * a.H + h) * a.Sq + row[i];
    lse[i] = row[i] < a.Sq ? a.lse[r] : 0.f;
    delta[i] = row[i] < a.Sq ? a.delta[r] : 0.f;
  }
  const bf16* q_w = q_s + warp * 16 * kLd;
  const bf16* do_w = do_s + warp * 16 * kLd;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int n_tiles = (a.Skv + kKeys - 1) / kKeys;
  if (a.causal)
    n_tiles = min(n_tiles, (min(q0 + kRows, a.Sq) - 1) / kKeys + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // q/do staged; the previous key tile is consumed
    load_tile<kKeys, D, kThreads>(k_s, kLd, k_b, kv_row, k0, a.Skv);
    load_tile<kKeys, D, kThreads>(v_s, kLd, v_b, kv_row, k0, a.Skv);
    __syncthreads();

    // s = q k^T and dp = do v^T for the strip's 16 rows and the tile's keys.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const AFrag fq = load_a(q_w, kLd, kk, gid, tig);
      const AFrag fo = load_a(do_w, kLd, kk, gid, tig);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int off = (n * 8 + gid) * kLd + kk * 16 + tig * 2;
        mma_tile(s[n], fq, ld32(k_s + off), ld32(k_s + off + 8));
        mma_tile(dp[n], fo, ld32(v_s + off), ld32(v_s + off + 8));
      }
    }
    // ds = p (dp - delta) scale, in place of s.
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = prob(s[n][e], lse[i], row[i],
                             k0 + n * 8 + tig * 2 + (e & 1), a);
        s[n][e] = p * (dp[n][e] - delta[i]) * a.sm_scale;
      }
    // dq += ds k: ds rounded to bf16 (k's dtype) is the A operand; k's rows
    // run down the product's K dimension (ldmatrix.trans).
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const AFrag fds = pack_a<NS>(s, kk);
      const bf16* kb = trans_rows(k_s, kLd, kk * 16, lane) + c0;
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, kb + n * 8);
        mma_tile(acc[n], fds, r[0], r[1]);
        mma_tile(acc[n + 1], fds, r[2], r[3]);
      }
    }
  }

  bf16* dq_b = static_cast<bf16*>(a.dq) + q_off + c0 + tig * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq_b + row[i] * q_row + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// dv = sum p^T do and dk = sum ds^T q over the G query heads of one KV head
// and their q tiles, one block per (64-row key tile, KV head and column
// half, batch). The strip's rows are keys; the score tile's columns are
// queries.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kQ = C::kQ, kOut = C::kOut;
  constexpr int NS = kQ / 8;
  constexpr int NO = kOut / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kRows, kLd]
  bf16* v_s = k_s + kRows * kLd;                  // [kRows, kLd]
  bf16* q_s = v_s + kRows * kLd;                  // [kQ, kLd]
  bf16* do_s = q_s + kQ * kLd;                    // [kQ, kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + kQ * kLd);  // [kQ]
  float* delta_s = lse_s + kQ;                                // [kQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * kRows;
  const int hk = blockIdx.y / C::kSplit;
  const int c0 = (blockIdx.y % C::kSplit) * kOut;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const size_t q_row = (size_t)a.H * D, kv_row = (size_t)a.Hkv * D;
  const size_t kv_off = (size_t)b * a.Skv * kv_row + (size_t)hk * D;

  load_tile<kRows, D, kThreads>(k_s, kLd, static_cast<const bf16*>(a.k) +
                                kv_off, kv_row, k0, a.Skv);
  load_tile<kRows, D, kThreads>(v_s, kLd, static_cast<const bf16*>(a.v) +
                                kv_off, kv_row, k0, a.Skv);
  const int key[2] = {k0 + warp * 16 + gid, k0 + warp * 16 + gid + 8};
  const bf16* k_w = k_s + warp * 16 * kLd;
  const bf16* v_w = v_s + warp * 16 * kLd;

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_tiles = (a.Sq + kQ - 1) / kQ;
  const int t0 = a.causal ? k0 / kQ : 0;  // q tiles wholly above skipped
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t q_off = (size_t)b * a.Sq * q_row + (size_t)h * D;
    const size_t l_off = ((size_t)b * a.H + h) * a.Sq;
    for (int t = t0; t < n_tiles; ++t) {
      const int qs0 = t * kQ;
      __syncthreads();  // the previous q tile is consumed
      load_tile<kQ, D, kThreads>(q_s, kLd, static_cast<const bf16*>(a.q) +
                                 q_off, q_row, qs0, a.Sq);
      load_tile<kQ, D, kThreads>(do_s, kLd,
                                 static_cast<const bf16*>(a.dout) + q_off,
                                 q_row, qs0, a.Sq);
      for (int i = threadIdx.x; i < kQ; i += kThreads) {
        const bool ok = qs0 + i < a.Sq;
        lse_s[i] = ok ? a.lse[l_off + qs0 + i] : 0.f;
        delta_s[i] = ok ? a.delta[l_off + qs0 + i] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v do^T: the strip's 16 keys against the
      // tile's queries.
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const AFrag fk = load_a(k_w, kLd, kk, gid, tig);
        const AFrag fv = load_a(v_w, kLd, kk, gid, tig);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int off = (n * 8 + gid) * kLd + kk * 16 + tig * 2;
          mma_tile(s[n], fk, ld32(q_s + off), ld32(q_s + off + 8));
          mma_tile(dp[n], fv, ld32(do_s + off), ld32(do_s + off + 8));
        }
      }
      // p^T in s, ds^T = p^T (dp^T - delta) scale in dp.
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + tig * 2 + (e & 1);
          const float p = prob(s[n][e], lse_s[qi], qs0 + qi, key[e >> 1], a);
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_s[qi]) * a.sm_scale;
        }
      // dv += p^T do (p rounded to do's dtype), dk += ds^T q (ds rounded to
      // q's dtype); do's and q's rows run down the K dimension.
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        const AFrag fp = pack_a<NS>(s, kk);
        const AFrag fds = pack_a<NS>(dp, kk);
        const bf16* ob = trans_rows(do_s, kLd, kk * 16, lane) + c0;
        const bf16* qb = trans_rows(q_s, kLd, kk * 16, lane) + c0;
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, ob + n * 8);
          mma_tile(dv[n], fp, r[0], r[1]);
          mma_tile(dv[n + 1], fp, r[2], r[3]);
          ldmatrix_x4_trans(r, qb + n * 8);
          mma_tile(dk[n], fds, r[0], r[1]);
          mma_tile(dk[n + 1], fds, r[2], r[3]);
        }
      }
    }
  }

  bf16* dk_b = static_cast<bf16*>(a.dk) + kv_off + c0 + tig * 2;
  bf16* dv_b = static_cast<bf16*>(a.dv) + kv_off + c0 + tig * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= a.Skv) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const size_t off = key[i] * kv_row + n * 8;
      *reinterpret_cast<__nv_bfloat162*>(dk_b + off) =
          __floats2bfloat162_rn(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_b + off) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores. Thread (ty, tx) = (tid / 8, tid % 8) owns rows ty + 16 i
// (i < 4) and, of a 32-wide step, columns tx + 8 j (j < 4); of the output,
// columns c0 + tx + 8 j (j < kOut / 8).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_simt_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int LD = C::kLdF, LP = C::kLp, kStep = C::kStep;
  constexpr int TO = C::kOut / 8;
  extern __shared__ float smem[];
  float* q_s = smem;                // [kRows, LD]
  float* do_s = q_s + kRows * LD;   // [kRows, LD]
  float* k_s = do_s + kRows * LD;   // [kStep, LD]
  float* v_s = k_s + kStep * LD;    // [kStep, LD]
  float* ds_s = v_s + kStep * LD;   // [kRows, LP]

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y / C::kSplit;
  const int c0 = (blockIdx.y % C::kSplit) * C::kOut;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const size_t q_row = (size_t)a.H * D, kv_row = (size_t)a.Hkv * D;
  const size_t q_off = (size_t)b * a.Sq * q_row + (size_t)h * D;
  const size_t kv_off = (size_t)b * a.Skv * kv_row + (size_t)hk * D;
  const float* k_b = static_cast<const float*>(a.k) + kv_off;
  const float* v_b = static_cast<const float*>(a.v) + kv_off;

  load_tile_f32<kRows, D, kThreads>(q_s, LD, static_cast<const float*>(a.q) +
                                    q_off, q_row, q0, a.Sq);
  load_tile_f32<kRows, D, kThreads>(
      do_s, LD, static_cast<const float*>(a.dout) + q_off, q_row, q0, a.Sq);
  float lse[4], delta[4], acc[4][TO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    const size_t r = ((size_t)b * a.H + h) * a.Sq + qp;
    lse[i] = qp < a.Sq ? a.lse[r] : 0.f;
    delta[i] = qp < a.Sq ? a.delta[r] : 0.f;
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (a.Skv + kStep - 1) / kStep;
  if (a.causal)
    n_tiles = min(n_tiles, (min(q0 + kRows, a.Sq) - 1) / kStep + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kStep;
    __syncthreads();
    load_tile_f32<kStep, D, kThreads>(k_s, LD, k_b, kv_row, k0, a.Skv);
    load_tile_f32<kStep, D, kThreads>(v_s, LD, v_b, kv_row, k0, a.Skv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = q_s[(ty + 16 * i) * LD + d];
        oa[i] = do_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = k_s[(tx + 8 * j) * LD + d];
        vb[j] = v_s[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qa[i] * kb[j];
          dp[i][j] += oa[i] * vb[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = prob(s[i][j], lse[i], q0 + ty + 16 * i,
                             k0 + tx + 8 * j, a);
        ds_s[(ty + 16 * i) * LP + tx + 8 * j] =
            p * (dp[i][j] - delta[i]) * a.sm_scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kStep; ++c) {
      float da[4], kb[TO];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = ds_s[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < TO; ++j) kb[j] = k_s[c * LD + c0 + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[i][j] += da[i] * kb[j];
    }
  }

  float* dq_b = static_cast<float*>(a.dq) + q_off + c0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < TO; ++j) dq_b[qp * q_row + tx + 8 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_simt_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int LD = C::kLdF, LP = C::kLp, kStep = C::kStep;
  constexpr int TO = C::kOut / 8;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [kRows, LD]
  float* v_s = k_s + kRows * LD;     // [kRows, LD]
  float* q_s = v_s + kRows * LD;     // [kStep, LD]
  float* do_s = q_s + kStep * LD;    // [kStep, LD]
  float* p_s = do_s + kStep * LD;    // [kRows, LP]
  float* ds_s = p_s + kRows * LP;    // [kRows, LP]
  float* lse_s = ds_s + kRows * LP;  // [kStep]
  float* delta_s = lse_s + kStep;    // [kStep]

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int k0 = blockIdx.x * kRows;
  const int hk = blockIdx.y / C::kSplit;
  const int c0 = (blockIdx.y % C::kSplit) * C::kOut;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const size_t q_row = (size_t)a.H * D, kv_row = (size_t)a.Hkv * D;
  const size_t kv_off = (size_t)b * a.Skv * kv_row + (size_t)hk * D;

  load_tile_f32<kRows, D, kThreads>(k_s, LD, static_cast<const float*>(a.k) +
                                    kv_off, kv_row, k0, a.Skv);
  load_tile_f32<kRows, D, kThreads>(v_s, LD, static_cast<const float*>(a.v) +
                                    kv_off, kv_row, k0, a.Skv);
  float dk[4][TO], dv[4][TO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TO; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_tiles = (a.Sq + kStep - 1) / kStep;
  const int t0 = a.causal ? k0 / kStep : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t q_off = (size_t)b * a.Sq * q_row + (size_t)h * D;
    const size_t l_off = ((size_t)b * a.H + h) * a.Sq;
    for (int t = t0; t < n_tiles; ++t) {
      const int qs0 = t * kStep;
      __syncthreads();
      load_tile_f32<kStep, D, kThreads>(
          q_s, LD, static_cast<const float*>(a.q) + q_off, q_row, qs0, a.Sq);
      load_tile_f32<kStep, D, kThreads>(
          do_s, LD, static_cast<const float*>(a.dout) + q_off, q_row, qs0,
          a.Sq);
      for (int i = threadIdx.x; i < kStep; i += kThreads) {
        const bool ok = qs0 + i < a.Sq;
        lse_s[i] = ok ? a.lse[l_off + qs0 + i] : 0.f;
        delta_s[i] = ok ? a.delta[l_off + qs0 + i] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qb[4], ob[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = k_s[(ty + 16 * i) * LD + d];
          va[i] = v_s[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = q_s[(tx + 8 * j) * LD + d];
          ob[j] = do_s[(tx + 8 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += ka[i] * qb[j];
            dp[i][j] += va[i] * ob[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 8 * j;
          const float p = prob(s[i][j], lse_s[qi], qs0 + qi,
                               k0 + ty + 16 * i, a);
          p_s[(ty + 16 * i) * LP + qi] = p;
          ds_s[(ty + 16 * i) * LP + qi] =
              p * (dp[i][j] - delta_s[qi]) * a.sm_scale;
        }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < kStep; ++c) {
        float pa[4], da[4], ob[TO], qb[TO];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = p_s[(ty + 16 * i) * LP + c];
          da[i] = ds_s[(ty + 16 * i) * LP + c];
        }
#pragma unroll
        for (int j = 0; j < TO; ++j) {
          ob[j] = do_s[c * LD + c0 + tx + 8 * j];
          qb[j] = q_s[c * LD + c0 + tx + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TO; ++j) {
            dv[i][j] += pa[i] * ob[j];
            dk[i][j] += da[i] * qb[j];
          }
      }
    }
  }

  float* dk_b = static_cast<float*>(a.dk) + kv_off + c0;
  float* dv_b = static_cast<float*>(a.dv) + kv_off + c0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      dk_b[kp * kv_row + tx + 8 * j] = dk[i][j];
      dv_b[kp * kv_row + tx + 8 * j] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at head_dim 64 and 128: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------
//
// Each pass takes one block of two consumer warpgroups (64 rows each) and
// one producer warpgroup. The block's resident tiles come in by TMA once; the
// streamed tiles come through a ring of kStages shared-memory stages, the
// producer waiting on a stage's `empty` barrier (one arrival per consumer
// warp) before it refills it and the consumers on its `full` barrier
// (the producer's arrival and the TMA bytes) before they read it.

constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kWgThreads = (kConsumers + 1) * 128;  // + the producer's
// Registers a thread after the split: the producer warpgroup gives its
// back (one warp of it issues the copies, the other three exit), the
// consumers take them: 40 * 128 + 232 * 256 of the SM's 65,536.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgCfg {
  // dk/dv pass: q tiles of 64 streamed against resident keys. At head_dim
  // 64 each consumer warpgroup owns 64 of the block's 128 keys. At 128
  // (kSplitCols) both take the block's 64 keys and each accumulates one
  // 64-column half of dk and dv, recomputing s and dp: a warpgroup holding
  // all 128 columns of dk and dv spilled at any q tile down to 16.
  static constexpr bool kSplitCols = D > 64;
  static constexpr int kKeys = kSplitCols ? 64 : 64 * kConsumers;
  static constexpr int kOut = kSplitCols ? 64 : D;  // dk, dv columns a wg
  static constexpr int kQ = 64;
  static constexpr int kDkvStages = 4;
  static constexpr size_t kDkvTiles =
      sizeof(bf16) * (2 * kKeys * D + 2 * kDkvStages * kQ * D);
  static constexpr size_t kDkvBytes =
      1024 + kDkvTiles + sizeof(float) * 2 * kDkvStages * kQ +
      sizeof(uint64_t) * (2 * kDkvStages + 1);
  // dq pass: 128 q rows resident, key tiles of kKv streamed (32 at
  // head_dim 128: at 64, ptxas spilled 32 bytes).
  static constexpr int kRowsQ = 64 * kConsumers;
  static constexpr int kKv = D > 64 ? 32 : 64;
  static constexpr int kDqStages = 4;
  static constexpr size_t kDqTiles =
      sizeof(bf16) * (2 * kRowsQ * D + 2 * kDqStages * kKv * D);
  static constexpr size_t kDqBytes =
      1024 + kDqTiles + sizeof(uint64_t) * (2 * kDqStages + 1);
};

// Descriptor offsets, in the descriptor's 16-byte units. K-major: K step
// kk of a tile of `rows` rows sits in region kk / 4, 32 bytes a step inside
// it. MN-major: K step kk is rows 16kk..16kk+15, 2048 bytes a step.
__host__ __device__ constexpr uint64_t kmajor_step(int rows, int kk) {
  return (uint64_t)((kk / 4) * rows * 8 + (kk % 4) * 2);
}
__host__ __device__ constexpr uint64_t mnmajor_step(int kk) {
  return (uint64_t)(kk * 128);
}
// The descriptor of a K-major tile at shared address `addr`, and of an
// MN-major one of `rows` rows (its 64-column regions rows * 128 bytes
// apart).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int rows) {
  return desc_sw128(addr, rows * 128, 1024);
}

// A value the compiler must take as new in every iteration: the loops
// derive every tile's descriptors from the shared-memory base inside the
// loop, instead of holding a dozen 64-bit descriptors in registers across
// it.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Round an m64nN accumulator to bf16 A fragments, one per K step of 16.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&c)[N / 2],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Store an m64nD fp32 accumulator as bf16 rows row[0], row[1] (skipped at
// or past n_rows) of a [rows, row_stride] matrix at base.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, size_t row_stride,
                                           const int (&row)[2], int n_rows,
                                           int tig, const float (&c)[D / 2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= n_rows) continue;
    bf16* p = base + (size_t)row[i] * row_stride + tig * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + j * 8) =
          __floats2bfloat162_rn(c[4 * j + 2 * i], c[4 * j + 2 * i + 1]);
  }
}

// dq = sum over key tiles of ds k: one block per (128-row q tile, head,
// batch), the last q tiles (the longest causal rows) of every head first.
// Q and dO stay
// resident; K and V tiles of 64 keys come through the ring up to the
// diagonal. Consumer warpgroup w owns rows q0 + 64w..q0 + 64w + 63. Its
// loop issues a tile's s and dp products, waits for them (and for the
// previous tile's dq product), frees the previous tile's stage, then turns
// s and dp into ds and issues dq += ds k without waiting: that product
// runs while the next tile's s and dp are issued.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const Args a) {
  using C = WgCfg<D>;
  constexpr int kRowsQ = C::kRowsQ, kKv = C::kKv, kStages = C::kDqStages;
  constexpr uint32_t kStageBytes = kKv * D * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(align_1024(smem_raw));  // [R][128][64]
  bf16* do_s = q_s + kRowsQ * D;
  bf16* k_s = do_s + kRowsQ * D;          // [stage][R][64][64]
  bf16* v_s = k_s + kStages * kKv * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * kKv * D);
  uint64_t* empty = full + kStages;
  uint64_t* resident = empty + kStages;

  const int n_qt = (a.Sq + kRowsQ - 1) / kRowsQ;
  const int n_bh = gridDim.x / n_qt;  // B * H
  const int bh = blockIdx.x % n_bh;  // b * H + h
  const int h = bh % a.H, b = bh / a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * kRowsQ;
  const int kvl = min(a.kv_len, a.Skv);
  int n_tiles = (kvl + kKv - 1) / kKv;
  if (a.causal)
    n_tiles = min(n_tiles, (min(q0 + kRowsQ, a.Sq) - 1) / kKv + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers * 4) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers * 4 || lane != 0) return;
    mbar_arrive_expect_tx(resident, 2 * kRowsQ * D * sizeof(bf16));
    tma_load_tile<D>(q_s, &map_q, resident, kRowsQ, h, q0, b);
    tma_load_tile<D>(do_s, &map_do, resident, kRowsQ, h, q0, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], 2 * kKv * D * sizeof(bf16));
      tma_load_tile<D>(k_s + s * kKv * D, &map_k, &full[s], kKv, hk, t * kKv,
                       b);
      tma_load_tile<D>(v_s + s * kKv * D, &map_v, &full[s], kKv, hk, t * kKv,
                       b);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
  const int qw0 = q0 + 64 * wg;  // the warpgroup's first row
  const int row[2] = {qw0 + (warp % 4) * 16 + gid,
                      qw0 + (warp % 4) * 16 + gid + 8};
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = ((size_t)b * a.H + h) * a.Sq + row[i];
    lse2[i] = row[i] < a.Sq ? a.lse[r] * kLog2e : 0.f;
    delta[i] = row[i] < a.Sq ? a.delta[r] : 0.f;
  }
  const float scale_log2 = a.sm_scale * kLog2e;
  // Shared addresses of the warpgroup's rows of q and do (A, K-major) and
  // of the ring's k and v tiles (B of s and dp, K-major; k again as B of
  // dq, MN-major), as offsets from the base.
  const uint32_t base = smem_u32(q_s);
  const uint32_t q_off = 64 * wg * 64 * sizeof(bf16);
  constexpr uint32_t do_off = kRowsQ * D * sizeof(bf16);
  constexpr uint32_t k_off = 2 * do_off;
  constexpr uint32_t v_off = k_off + kStages * kKv * D * sizeof(bf16);
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(resident, 0);

  int prev = -1;  // the stage whose dq product may still be running
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKv;
    const bool skip = qw0 >= a.Sq || (a.causal && k0 > qw0 + 63);
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    float sc[kKv / 2], dp[kKv / 2];
    if (!skip) {
      // s = q k^T and dp = do v^T for the warpgroup's 64 rows.
      const uint32_t sb = opaque(base);
      const uint64_t qd = kmajor_desc(sb + q_off);
      const uint64_t od = kmajor_desc(sb + do_off + q_off);
      const uint64_t kd = kmajor_desc(sb + k_off + s * kStageBytes);
      const uint64_t vd = kmajor_desc(sb + v_off + s * kStageBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kKv>(sc, qd + kmajor_step(kRowsQ, kk),
                      kd + kmajor_step(kKv, kk), kk > 0);
        wgmma_ss<kKv>(dp, od + kmajor_step(kRowsQ, kk),
                      vd + kmajor_step(kKv, kk), kk > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = s;
    if (skip) continue;
    reg_fence(sc);
    reg_fence(dp);
    // ds = p (dp - delta) scale, p = exp(s scale - lse); masks only where
    // the tile crosses the diagonal, kv_len or the rows' end.
    const bool edge = (a.causal && k0 + kKv - 1 > qw0) || k0 + kKv > kvl ||
                      qw0 + 64 > a.Sq;
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2_approx(sc[4 * j + e] * scale_log2 - lse2[i]);
        if (edge) {
          const int kp = k0 + j * 8 + tig * 2 + (e & 1);
          if (row[i] >= a.Sq || kp >= kvl || (a.causal && kp > row[i]))
            p = 0.f;
        }
        sc[4 * j + e] = p * (dp[4 * j + e] - delta[i]) * a.sm_scale;
      }
    // dq += ds k: ds rounded to bf16 (k's dtype) is the register A operand;
    // k's rows run down K (MN-major B).
    uint32_t ds[kKv / 16][4];
    to_a_frags<kKv>(sc, ds);
    reg_fence(ds);
    reg_fence(dq);
    const uint64_t kmd =
        mnmajor_desc(opaque(base) + k_off + s * kStageBytes, kKv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk)
      wgmma_rs<D>(dq, ds[kk], kmd + mnmajor_step(kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(dq);
  if (prev >= 0) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }

  store_rows<D>(static_cast<bf16*>(a.dq) + (size_t)b * a.Sq * a.H * D +
                    (size_t)h * D,
                (size_t)a.H * D, row, a.Sq, tig, dq);
}

// What a dk/dv block works on: its batch, KV head and key tile (heaviest,
// the first key tiles, first), and its steps over (query head, q tile),
// head-major, q tiles wholly above the diagonal skipped.
template <int D>
struct DkvWork {
  int b, hk, k0, G, t0, n_t, n_iter;
  __device__ __forceinline__ DkvWork(const Args& a, int block) {
    constexpr int kKeys = WgCfg<D>::kKeys, kQ = WgCfg<D>::kQ;
    const int n_bh = gridDim.x / ((a.Skv + kKeys - 1) / kKeys);  // B * Hkv
    hk = block % n_bh % a.Hkv;
    b = block % n_bh / a.Hkv;
    k0 = block / n_bh * kKeys;
    G = a.H / a.Hkv;
    t0 = a.causal ? k0 / kQ : 0;
    n_t = max((a.Sq + kQ - 1) / kQ - t0, 0);  // q tiles a head
    n_iter = G * n_t;
  }
};

// dv = sum p^T do and dk = sum ds^T q over the G query heads of one KV
// head and their q tiles: one block per (key tile, KV head, batch), the
// first key tiles (the most causal q tiles) of every KV head first. K and V
// stay resident;
// q, do, lse and delta tiles come through the ring, from the diagonal on
// (the producer's lanes fetch the next tile's lse and delta while they
// wait for a free stage). Consumer warpgroup w owns keys k0 + 64w..k0 +
// 64w + 63 (at head_dim 128: keys k0..k0 + 63, columns 64w..64w + 63); the
// score tile's rows are its keys and its columns the tile's queries. Unlike the dq pass, it waits for its dk and dv products before
// it frees the stage and takes the next tile: holding p, ds and the next
// tile's s and dp at once left ptxas too few registers, and it serialised
// every wgmma and spilled.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const Args a) {
  using C = WgCfg<D>;
  constexpr int kKeys = C::kKeys, kQ = C::kQ, kStages = C::kDkvStages;
  constexpr uint32_t kStageBytes = kQ * D * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(align_1024(smem_raw));  // [R][128][64]
  bf16* v_s = k_s + kKeys * D;
  bf16* q_s = v_s + kKeys * D;            // [stage][R][kQ][64]
  bf16* do_s = q_s + kStages * kQ * D;
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * kQ * D);
  float* delta_s = lse_s + kStages * kQ;  // [stage][kQ] each
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + kStages * kQ);
  uint64_t* empty = full + kStages;
  uint64_t* resident = empty + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers * 4) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers * 4) return;
    // Its own copy of the block's work, from a block index the compiler
    // cannot share with the consumers' (a value computed before the split
    // and live across it was spilled).
    const DkvWork<D> w(a, (int)opaque(blockIdx.x));
    const int hk = w.hk, b = w.b, G = w.G, t0 = w.t0, n_t = w.n_t;
    if (lane == 0) {
      mbar_arrive_expect_tx(resident, 2 * kKeys * D * sizeof(bf16));
      tma_load_tile<D>(k_s, &map_k, resident, kKeys, hk, w.k0, b);
      tma_load_tile<D>(v_s, &map_v, resident, kKeys, hk, w.k0, b);
    }
    // Step j's lse (times log2 e) and delta, entry lane + 32 i of the tile.
    constexpr int kPer = (kQ + 31) / 32;
    float lse_r[kPer], delta_r[kPer];
    auto fetch = [&](int j) {
      const int g = j / n_t, t = t0 + j % n_t;
      const size_t l_off = ((size_t)b * a.H + hk * G + g) * a.Sq;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int qp = t * kQ + lane + 32 * i;
        const bool ok = lane + 32 * i < kQ && qp < a.Sq;
        lse_r[i] = ok ? a.lse[l_off + qp] * kLog2e : 0.f;
        delta_r[i] = ok ? a.delta[l_off + qp] : 0.f;
      }
    };
    if (w.n_iter > 0) fetch(0);
    for (int j = 0; j < w.n_iter; ++j) {
      const int s = j % kStages;
      const int g = j / n_t, t = t0 + j % n_t;
      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (lane + 32 * i < kQ) {
          lse_s[s * kQ + lane + 32 * i] = lse_r[i];
          delta_s[s * kQ + lane + 32 * i] = delta_r[i];
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kQ * D * sizeof(bf16));
        tma_load_tile<D>(q_s + s * kQ * D, &map_q, &full[s], kQ, hk * G + g,
                         t * kQ, b);
        tma_load_tile<D>(do_s + s * kQ * D, &map_do, &full[s], kQ,
                         hk * G + g, t * kQ, b);
      } else {
        mbar_arrive(&full[s]);
      }
      if (j + 1 < w.n_iter) fetch(j + 1);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const DkvWork<D> w(a, blockIdx.x);
  const int hk = w.hk, b = w.b, k0 = w.k0, t0 = w.t0, n_t = w.n_t;
  const int n_iter = w.n_iter;

  const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
  const int kw0 = k0 + (C::kSplitCols ? 0 : 64 * wg);  // its first key
  const int c0 = C::kSplitCols ? 64 * wg : 0;          // its first column
  const int key[2] = {kw0 + (warp % 4) * 16 + gid,
                      kw0 + (warp % 4) * 16 + gid + 8};
  const int kvl = min(a.kv_len, a.Skv);
  const bool live = kw0 < kvl;  // else its dk and dv are 0
  const float scale_log2 = a.sm_scale * kLog2e;
  // Shared addresses of the warpgroup's keys of k and v (A, K-major) and
  // of the ring's q and do tiles (B of s^T and dp^T, K-major; B of dk and
  // dv, MN-major), as offsets from the base.
  const uint32_t base = smem_u32(k_s);
  const uint32_t k_off = (kw0 - k0) * 64 * sizeof(bf16);
  constexpr uint32_t v_off = kKeys * D * sizeof(bf16);
  constexpr uint32_t q_off = 2 * v_off;
  constexpr uint32_t do_off = q_off + kStages * kStageBytes;
  // The region of the warpgroup's columns in the ring's q and do tiles.
  const uint32_t c_off = c0 * kQ * sizeof(bf16);
  constexpr int kOut = C::kOut;
  float dk[kOut / 2], dv[kOut / 2];
#pragma unroll
  for (int i = 0; i < kOut / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(resident, 0);

  for (int j = 0; j < n_iter; ++j) {
    const int t = t0 + j % n_t;
    const int qs0 = t * kQ;
    const bool skip = !live || (a.causal && qs0 + kQ <= kw0);
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (!skip) {
      // s^T = k q^T and dp^T = v do^T: the warpgroup's 64 keys against the
      // tile's queries.
      const uint32_t sb = opaque(base);
      const uint64_t kd = kmajor_desc(sb + k_off);
      const uint64_t vd = kmajor_desc(sb + v_off + k_off);
      const uint64_t qd = kmajor_desc(sb + q_off + s * kStageBytes);
      const uint64_t od = kmajor_desc(sb + do_off + s * kStageBytes);
      float sc[kQ / 2], dp[kQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kQ>(sc, kd + kmajor_step(kKeys, kk),
                     qd + kmajor_step(kQ, kk), kk > 0);
        wgmma_ss<kQ>(dp, vd + kmajor_step(kKeys, kk),
                     od + kmajor_step(kQ, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      reg_fence(dp);
      // p^T in sc, ds^T = p^T (dp^T - delta) scale in dp.
      const float* lse_t = lse_s + s * kQ;
      const float* delta_t = delta_s + s * kQ;
      const bool edge = (a.causal && qs0 < kw0 + 64) || qs0 + kQ > a.Sq ||
                        kw0 + 64 > kvl;
#pragma unroll
      for (int jj = 0; jj < kQ / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = jj * 8 + tig * 2 + (e & 1);
          const int kp = key[e >> 1];
          float p = exp2_approx(sc[4 * jj + e] * scale_log2 - lse_t[qi]);
          if (edge && (qs0 + qi >= a.Sq || kp >= kvl ||
                       (a.causal && kp > qs0 + qi)))
            p = 0.f;
          sc[4 * jj + e] = p;
          dp[4 * jj + e] = p * (dp[4 * jj + e] - delta_t[qi]) * a.sm_scale;
        }
      // dv += p^T do (p rounded to do's dtype), dk += ds^T q (ds rounded
      // to q's dtype): register A operands; do's and q's rows run down K.
      uint32_t pa[kQ / 16][4], da[kQ / 16][4];
      to_a_frags<kQ>(sc, pa);
      to_a_frags<kQ>(dp, da);
      reg_fence(pa);
      reg_fence(da);
      reg_fence(dv);
      reg_fence(dk);
      const uint64_t omd =
          mnmajor_desc(sb + do_off + s * kStageBytes + c_off, kQ);
      const uint64_t qmd =
          mnmajor_desc(sb + q_off + s * kStageBytes + c_off, kQ);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        wgmma_rs<kOut>(dv, pa[kk], omd + mnmajor_step(kk), 1);
        wgmma_rs<kOut>(dk, da[kk], qmd + mnmajor_step(kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t kv_off =
      (size_t)b * a.Skv * a.Hkv * D + (size_t)hk * D + c0;
  store_rows<kOut>(static_cast<bf16*>(a.dk) + kv_off, (size_t)a.Hkv * D,
                   key, a.Skv, tig, dk);
  store_rows<kOut>(static_cast<bf16*>(a.dv) + kv_off, (size_t)a.Hkv * D,
                   key, a.Skv, tig, dv);
}

// ---------------------------------------------------------------------------
// delta = rowsum(do * o) in fp32, [B, H, Sq], ahead of both passes
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot16(const uint4& x, const uint4& y,
                                       const bf16*) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(a[i]), fb = __bfloat1622float2(b[i]);
    s += fa.x * fb.x + fa.y * fb.y;
  }
  return s;
}
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y,
                                       const float*) {
  const float4 a = *reinterpret_cast<const float4*>(&x);
  const float4 b = *reinterpret_cast<const float4*>(&y);
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Rows of [B, Sq, H, D] o and do, one group of kLanes lanes a row, 16 bytes
// a load; the row's sum goes to delta[b, h, s].
template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* o, const T* dout, float* delta, int rows,
                           int Sq, int H) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = D / kVec > 32 ? 32 : D / kVec;
  constexpr int kLoads = D / kVec / kLanes;
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = gt / kLanes, l = gt % kLanes;
  float acc = 0.f;
  if (r < rows) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const size_t off = (size_t)r * D + (size_t)(l + i * kLanes) * kVec;
      acc += dot16(*reinterpret_cast<const uint4*>(o + off),
                   *reinterpret_cast<const uint4*>(dout + off),
                   static_cast<const T*>(nullptr));
    }
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (r < rows && l == 0) {
    const int h = r % H, bs = r / H;
    delta[((size_t)(bs / Sq) * H + h) * Sq + bs % Sq] = acc;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch_one(Kernel kernel, dim3 grid, size_t smem, const Args& a,
               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, int B, int dtype, cudaStream_t stream) {
  using C = Cfg<D>;
  const dim3 dq_grid((a.Sq + kRows - 1) / kRows, a.H * C::kSplit, B);
  const dim3 dkv_grid((a.Skv + kRows - 1) / kRows, a.Hkv * C::kSplit, B);
  int err;
  if (dtype == 0) {
    err = launch_one(flash_bwd_dq_simt_kernel<D>, dq_grid, C::kDqBytesF, a,
                     stream);
    if (err) return err;
    return launch_one(flash_bwd_dkv_simt_kernel<D>, dkv_grid, C::kDkvBytesF,
                      a, stream);
  }
  if constexpr (D > 128) {  // bf16 at head_dim 64 and 128: launch_wgmma
    if (dtype == 1) {
      err = launch_one(flash_bwd_dq_mma_kernel<D>, dq_grid, C::kDqBytes, a,
                       stream);
      if (err) return err;
      return launch_one(flash_bwd_dkv_mma_kernel<D>, dkv_grid, C::kDkvBytes,
                        a, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Kernel>
int launch_wg(Kernel kernel, unsigned grid, size_t smem,
              const CUtensorMap (&m)[4], const Args& a,
              cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWgThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return (int)cudaGetLastError();
}

// The bf16 wgmma passes: TMA maps of q, k, v, do with each pass's box
// heights, then the dq pass and the dk/dv pass.
template <int D>
int launch_wgmma(const Args& a, int B, cudaStream_t stream) {
  using C = WgCfg<D>;
  CUtensorMap dq_maps[4], dkv_maps[4];
  const void* src[4] = {a.q, a.k, a.v, a.dout};
  for (int i = 0; i < 4; ++i) {
    const bool kv = i == 1 || i == 2;
    const int S = kv ? a.Skv : a.Sq, H = kv ? a.Hkv : a.H;
    int err = encode_bshd_map(&dq_maps[i], src[i], B, S, H, D,
                              kv ? C::kKv : C::kRowsQ);
    if (!err)
      err = encode_bshd_map(&dkv_maps[i], src[i], B, S, H, D,
                            kv ? C::kKeys : C::kQ);
    if (err) return err;
  }
  const unsigned dq_grid = a.H * B * ((a.Sq + C::kRowsQ - 1) / C::kRowsQ);
  const unsigned dkv_grid =
      a.Hkv * B * ((a.Skv + C::kKeys - 1) / C::kKeys);
  const int err = launch_wg(flash_bwd_dq_wgmma_kernel<D>, dq_grid,
                            C::kDqBytes, dq_maps, a, stream);
  if (err) return err;
  return launch_wg(flash_bwd_dkv_wgmma_kernel<D>, dkv_grid, C::kDkvBytes,
                   dkv_maps, a, stream);
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int B,
                 int Sq, int H, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = D / kVec > 32 ? 32 : D / kVec;
  const int rows = B * Sq * H;
  const unsigned blocks = (unsigned)(((long long)rows * kLanes + 255) / 256);
  flash_bwd_delta_kernel<T, D><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, Sq,
      H);
  return (int)cudaGetLastError();
}

template <int D>
int run(const Args& a, const void* o, float* delta, int B, int dtype,
        cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int err =
      dtype == 0
          ? launch_delta<float, D>(o, a.dout, delta, B, a.Sq, a.H, stream)
          : launch_delta<bf16, D>(o, a.dout, delta, B, a.Sq, a.H, stream);
  if (err) return err;
  if constexpr (D <= 128) {
    if (dtype == 1) return launch_wgmma<D>(a, B, stream);
  }
  return launch<D>(a, B, dtype, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv); lse is
// float32 [B, H, Sq], delta a float32 [B, H, Sq] scratch the first kernel
// fills. D in {64, 128, 256}; kv_len in [1, Skv] (Skv when unmasked).
// Launches the delta pre-pass, then the dq pass, then the dk/dv pass, on
// `stream`: bf16 at D 64 and 128 through the wgmma kernels, bf16 at D 256
// through the mma.sync kernels, fp32 through the CUDA-core kernels.
// Returns the first non-zero cudaError_t of the launches, else 0.
extern "C" int pdtx_flash_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int B, int Sq, int Skv,
                              int H, int Hkv, int D, int causal, int kv_len,
                              float sm_scale, int dtype, void* stream) {
  float* delta_f = static_cast<float*>(delta);
  const Args a{q, k, v, dout, static_cast<const float*>(lse), delta_f, dq,
               dk, dv, Sq, Skv, H, Hkv, causal, kv_len, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return run<64>(a, o, delta_f, B, dtype, s);
    case 128:
      return run<128>(a, o, delta_f, B, dtype, s);
    case 256:
      return run<256>(a, o, delta_f, B, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
