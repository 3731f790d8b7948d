// Fused BN-apply/ReLU -> 1x1-conv matmul -> BN statistics for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_kernel` of pytorch_distributed_training_
// example_tpu/ops/fused_bn_matmul.py (via `fused_stats_matmul`): in one pass
// over x [N, K],
// - prologue: the previous BatchNorm's per-channel fold x * scale + bias
//   and ReLU (each optional), in fp32 registers, rounded once to w's dtype;
// - body: y = x' @ w [K, C] with fp32 accumulation, y stored in x's dtype;
// - epilogue: per-column sum(y) and sum(y^2) from the fp32 accumulators (not
//   from the rounded y), the statistics the next BatchNorm needs.
//
// What bounds it on this card: bytes. A 1x1 conv of a ResNet bottleneck does
// 2 K flops per byte of x it reads (K = 64..512), far below the H100's ~295
// flop/byte balance point: the least time is reading x once and writing y
// once at 3.35 TB/s ([401408, 256] @ [256, 64] in bf16: 0.077 ms).
//
// What the design does about it (bf16): one launch of a persistent,
// warp-specialised wgmma kernel that keeps the card's memory busy.
// - One block an SM. The columns of y are cut into chunks of 64, 128 or 256
//   (one chunk for every C up to 256); block b takes chunk b % n_chunks and
//   walks that chunk's row tiles slot, slot + slots, ... (slot = b /
//   n_chunks, slots blocks a chunk): a fixed order, so the order of each
//   block's sums does not depend on timing, and no grid limit caps N. The
//   schedule is `_bn_schedule` in ops/fused_bn_matmul.py, which passes the
//   chunk and the slots.
// - A producer warpgroup (setmaxnreg 40) of which one thread keeps a ring
//   of TMA stages full: a stage is a 64-column slice of x's rows, 128-byte
//   swizzled, rows past N zero-filled. The ring runs across tiles, so the
//   next tile's loads overlap this tile's epilogue. w's chunk (read
//   MN-major) is loaded once into shared memory where it fits beside the
//   ring (up to [512, 128]); otherwise each stage carries w's slice too,
//   from L2.
// - Two consumer warpgroups (setmaxnreg 232). At a chunk of 64 or 128 each
//   takes 64 rows of a 128-row tile and the whole chunk; at 256 both take
//   the same 64-row tile and 128 columns each, so that x is read once and
//   no column is padding up to C = 256. A warp reads its 16 rows of the
//   stage with ldmatrix, applies the prologue in fp32 (x * scale rounded,
//   + bias rounded, ReLU, one rounding to bf16: the plain version's two
//   PyTorch operations; scale and bias staged in shared memory once a
//   block, since loads from L1 beside a full ring cost more than the
//   product) and hands the result to wgmma as its register A operand
//   (m64n64k16 or m64n128k16).
// - y is rounded to bf16, staged in swizzled shared memory and written by
//   TMA stores (rows past N and columns past C clipped by the map), two
//   staging buffers a warpgroup where they fit, so that a tile's epilogue
//   waits for the store of two tiles back, not the last one.
// - Statistics: each thread sums its rows' fp32 accumulators per column in
//   registers across all of its block's tiles (rows past N left out: an
//   affine prologue turns a zero row of x into relu(bias)); a lane pair
//   (gid, gid ^ 1) adds its tile sums with one shuffle and each keeps one
//   column of two, which halves the registers they take. At the end the
//   block reduces them (shuffles across the lane pairs of a column, then
//   the warps in order) into its [2, chunk] partial in a workspace.
// - Merge in the same launch: the block that arrives last (one acq_rel
//   atom.inc that wraps the counter back to 0, so the wrapper's counters
//   stay zero between calls) sums the partials of each column in slot
//   order. No float atomics, no memset, no second launch: the statistics
//   are bitwise the same from call to call.
// fp32 keeps fp32 products (the tensor cores would round them to TF32) and
// runs on the CUDA cores from a 4 x 4 register tile per thread, 64 x 64
// tiles, on the same persistent schedule and the same merge.

#include "hopper.cuh"

namespace {

using namespace pdtx;
using bf16 = __nv_bfloat16;

constexpr int kAffine = 1;   // flags: apply x * scale + bias
constexpr int kRelu = 2;     // flags: then max(., 0)

// ---------------------------------------------------------------------------
// The ordered merge (both dtypes)
// ---------------------------------------------------------------------------

constexpr int kMergeCols = 4;       // 32-value columns of work a round
constexpr int kMergeDepth = 8;      // slots a warp loads at once per column

// stats[j] = the sum over slots p of partial[p][j], j < n_vals: warp w sums
// slots w, w + 8, ... in order (kMergeCols x 32 values a round, lane = the
// value), then the 8 warps' sums are added in warp order. Run by 256
// threads (tid) of the block that arrived last; red holds
// kMergeCols x 8 x 32 floats; sync is a barrier over those threads.
template <typename Sync>
__device__ __forceinline__ void merge_partials(const float* partial,
                                               float* stats, int n_slots,
                                               int n_vals, int tid,
                                               float* red, Sync sync) {
  const int warp = tid / 32, lane = tid % 32;
  for (int j0 = 0; j0 < n_vals; j0 += kMergeCols * 32) {
    float acc[kMergeCols] = {};
    for (int p0 = warp; p0 < n_slots; p0 += 8 * kMergeDepth) {
      float v[kMergeDepth][kMergeCols];
#pragma unroll
      for (int u = 0; u < kMergeDepth; ++u)
#pragma unroll
        for (int c = 0; c < kMergeCols; ++c) {
          const int pp = p0 + 8 * u, j = j0 + 32 * c + lane;
          const bool in = pp < n_slots && j < n_vals;
          v[u][c] = in ? __ldcg(partial + (size_t)pp * n_vals + j) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kMergeDepth; ++u)
#pragma unroll
        for (int c = 0; c < kMergeCols; ++c) acc[c] += v[u][c];
    }
#pragma unroll
    for (int c = 0; c < kMergeCols; ++c)
      red[(c * 8 + warp) * 32 + lane] = acc[c];
    sync();
    if (tid < kMergeCols * 32) {
      const int c = tid / 32, j = j0 + tid;
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) total += red[(c * 8 + w) * 32 + lane];
      if (j < n_vals) stats[j] = total;
    }
    sync();
  }
}

// The prologue on one A register: two bf16 values of x in columns k, k + 1,
// with their scale and bias pairs.
template <int FLAGS>
__device__ __forceinline__ uint32_t prologue(uint32_t pair, float2 s,
                                             float2 b) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&pair);
  float2 f = __bfloat1622float2(h);
  if (FLAGS & kAffine) {
    f.x = __fadd_rn(__fmul_rn(f.x, s.x), b.x);
    f.y = __fadd_rn(__fmul_rn(f.y, s.y), b.y);
  }
  if (FLAGS & kRelu) {
    f.x = fmaxf(f.x, 0.f);
    f.y = fmaxf(f.y, 0.f);
  }
  return pack_bf16(f.x, f.y);
}

// The prologue on a warp's A fragments of one 64-deep slice: fragment kk
// holds columns k, k + 1 (registers 0, 1) and k + 8, k + 9 (2, 3) of k =
// 16 kk + 2 tig; sb holds the slice's scale, then its bias (64 each).
template <int FLAGS>
__device__ __forceinline__ void apply_prologue(uint32_t (&af)[4][4],
                                               const float* sb, int tig) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = kk * 16 + tig * 2;
    const float2 s_lo = *reinterpret_cast<const float2*>(sb + k);
    const float2 s_hi = *reinterpret_cast<const float2*>(sb + k + 8);
    const float2 b_lo = *reinterpret_cast<const float2*>(sb + 64 + k);
    const float2 b_hi = *reinterpret_cast<const float2*>(sb + 64 + k + 8);
    af[kk][0] = prologue<FLAGS>(af[kk][0], s_lo, b_lo);
    af[kk][1] = prologue<FLAGS>(af[kk][1], s_lo, b_lo);
    af[kk][2] = prologue<FLAGS>(af[kk][2], s_hi, b_hi);
    af[kk][3] = prologue<FLAGS>(af[kk][3], s_hi, b_hi);
  }
}

// ---------------------------------------------------------------------------
// bf16: persistent wgmma kernel fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // two consumer warpgroups + the producer
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kSliceK = 64;       // depth of a stage: one swizzled row
constexpr uint32_t kRegion = 64 * 128;  // a 64-row x 64-column box, 8 KB
constexpr int kMaxStages = 16;
constexpr uint32_t kRingBytes = 128 * 1024;  // most bytes a ring holds
constexpr int kSyncConsumers = 3;  // named barrier of the 256 consumers

struct BnArgs {
  const float* scale;  // [K] fp32, read when flags & kAffine
  const float* bias;
  float* partial;      // [slots, 2, C]
  float* stats;        // [2, C]
  unsigned* counter;   // one, zero between calls
  int N, K, C, flags;
  int n_chunks, slots, n_tiles, n_k;
  int stages;          // ring depth
  int stage_bytes;     // x slice (+ w slice when not resident)
  int resident;        // w's chunk stays in shared memory
  int stg_bufs;        // y staging buffers a warpgroup: 1 or 2
  uint32_t w_off, stg_off, sb_off, bar_off;  // offsets from the base
};

// y [N, C] = prologue(x) @ w and the [2, C] statistics. NW: the columns of
// one warpgroup's wgmma; COLS: the warpgroups split a 2 NW chunk's columns
// over one 64-row tile, else each takes 64 rows of a 128-row tile and the
// NW-column chunk. map_x: x [N, K] in boxes of 64 (COLS) or 128 rows; map_w:
// w [K, C] in boxes of 64 rows; map_y: y [N, C] in boxes of 64 rows.
template <int NW, bool COLS>
__global__ void __launch_bounds__(kWgThreads, 1)
    bn_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_y,
                           const BnArgs a) {
  constexpr int kTileRows = COLS ? 64 : 128;
  constexpr int kChunk = COLS ? 2 * NW : NW;
  constexpr uint32_t kXBytes = kTileRows * 128;
  constexpr uint32_t kWSlice = kChunk * 128;  // 64 rows of the chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.bar_off);
  uint64_t* empty = full + kMaxStages;
  uint64_t* w_full = empty + kMaxStages;
  int* flag = reinterpret_cast<int*>(w_full + 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(w_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = blockIdx.x % a.n_chunks, slot = blockIdx.x / a.n_chunks;
  const int n0 = chunk * kChunk;
  // w's 64-column boxes that start before C (the rest hold nothing kept).
  const int nb = min(kChunk / 64, (a.C - n0 + 63) / 64);

  if (warp >= 8) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    if (a.resident) {
      mbar_arrive_expect_tx(w_full, a.n_k * nb * kRegion);
      for (int ks = 0; ks < a.n_k; ++ks)
        for (int c = 0; c < nb; ++c)
          tma_load_2d(smem + a.w_off + ks * kWSlice + c * kRegion, &map_w,
                      w_full, n0 + 64 * c, ks * kSliceK);
    }
    const uint32_t bytes = kXBytes + (a.resident ? 0 : nb * kRegion);
    int it = 0;
    for (int t = slot; t < a.n_tiles; t += a.slots)
      for (int ks = 0; ks < a.n_k; ++ks, ++it) {
        const int s = it % a.stages;
        unsigned char* st = smem + s * a.stage_bytes;
        mbar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], bytes);
        tma_load_2d(st, &map_x, &full[s], ks * kSliceK, t * kTileRows);
        if (!a.resident)
          for (int c = 0; c < nb; ++c)
            tma_load_2d(st + kXBytes + c * kRegion, &map_w, &full[s],
                        n0 + 64 * c, ks * kSliceK);
      }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4, wl = warp % 4, wt = threadIdx.x % 128;
  const int gid = lane / 4, tig = lane % 4;
  // ldmatrix: lanes 8m..8m+7 address the rows of matrix m (rows 0-7, 8-15
  // of the warp's strip at k 0-7, then at k 8-15); a row's 16-byte chunk
  // c sits at c ^ (row % 8), and row % 8 = lane % 8.
  const int a_row = (COLS ? 0 : 64 * wg) + 16 * wl + (lane & 15);
  const uint32_t a_off = a_row * 128, a_sw = lane & 7, a_hi = lane >> 4;
  // The warpgroup's columns of the chunk, and its B regions.
  const int c0 = COLS ? NW * wg : 0;
  const uint32_t b_off = (c0 / 64) * kRegion;
  constexpr uint32_t kStgBytes = (NW / 64) * kRegion;  // 64 rows x NW
  unsigned char* stg = smem + a.stg_off + wg * a.stg_bufs * kStgBytes;

  // Scale and bias in shared memory, slice by slice ([n_k][2][64], zero
  // past K: x and w are zero there too).
  float* sb_s = reinterpret_cast<float*>(smem + a.sb_off);
  if (a.flags & kAffine)
    for (int k = threadIdx.x; k < a.n_k * kSliceK; k += 256) {
      float* at = sb_s + k / kSliceK * 2 * kSliceK + k % kSliceK;
      at[0] = k < a.K ? a.scale[k] : 0.f;
      at[kSliceK] = k < a.K ? a.bias[k] : 0.f;
    }
  named_barrier(kSyncConsumers, 256);

  // Column sums and sums of squares of the block's rows so far: s1[j] and
  // s2[j] for column 8 j + 2 tig + odd, summed over this lane and lane
  // ^ 4 (gid ^ 1), which keeps the other column of the pair.
  float acc[NW / 2];
  float s1[NW / 8], s2[NW / 8];
  const int odd = gid & 1;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) s1[j] = s2[j] = 0.f;
  if (a.resident) mbar_wait(w_full, 0);
  int n_stored = 0;  // tiles whose y went out through this staging

  int it = 0;
  for (int t = slot; t < a.n_tiles; t += a.slots) {
    for (int ks = 0; ks < a.n_k; ++ks, ++it) {
      const int s = it % a.stages;
      mbar_wait(&full[s], (it / a.stages) & 1);
      const uint32_t base = opaque(smem_u32(smem));
      const uint32_t xs = base + s * a.stage_bytes;
      uint32_t af[kSliceK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kSliceK / 16; ++kk) {
        const uint32_t addr = xs + a_off + (((2 * kk + a_hi) ^ a_sw) << 4);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(af[kk][0]), "=r"(af[kk][1]), "=r"(af[kk][2]),
              "=r"(af[kk][3])
            : "r"(addr));
      }
      const float* sb = sb_s + ks * 2 * kSliceK;
      if (a.flags == (kAffine | kRelu))
        apply_prologue<kAffine | kRelu>(af, sb, tig);
      else if (a.flags == kAffine)
        apply_prologue<kAffine>(af, sb, tig);
      else if (a.flags == kRelu)
        apply_prologue<kRelu>(af, sb, tig);
      // With w resident the stage held only x, now in registers.
      if (a.resident) warp_arrive(&empty[s], lane);
      const uint32_t wb = a.resident ? base + a.w_off + ks * kWSlice
                                     : xs + kXBytes;
      const uint64_t bd = mnmajor_desc(wb + b_off, kSliceK);
      reg_fence(af);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceK / 16; ++kk)
        wgmma_rs<NW>(acc, af[kk], bd + mnmajor_step(kk), ks | kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(af);
      if (!a.resident) warp_arrive(&empty[s], lane);
    }

    // The warpgroup's 64 rows from r0: statistics, then y.
    const int r0 = t * kTileRows + (COLS ? 0 : 64 * wg);
    const int row = r0 + 16 * wl + gid;
    const bool v0 = row < a.N, v1 = row + 8 < a.N;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      float t1[2], t2[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float x0 = v0 ? acc[4 * j + b] : 0.f;
        const float x1 = v1 ? acc[4 * j + 2 + b] : 0.f;
        t1[b] = x0 + x1;
        t2[b] = fmaf(x1, x1, x0 * x0);
        t1[b] += __shfl_xor_sync(0xffffffffu, t1[b], 4);
        t2[b] += __shfl_xor_sync(0xffffffffu, t2[b], 4);
      }
      s1[j] += odd ? t1[1] : t1[0];
      s2[j] += odd ? t2[1] : t2[0];
    }
    // The staging buffer's last store (one or two tiles back) has read it.
    if (wt == 0) {
      if (a.stg_bufs == 2)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
    }
    named_barrier(1 + wg, 128);
    unsigned char* out = stg + (n_stored++ % a.stg_bufs) * kStgBytes;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wl + gid + 8 * h;  // r % 8 == gid
        *reinterpret_cast<uint32_t*>(
            out + (j / 8) * kRegion + r * 128 + (((j % 8) ^ gid) << 4) +
            4 * tig) = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wt == 0) {
#pragma unroll
      for (int c = 0; c < NW / 64; ++c)
        if (n0 + c0 + 64 * c < a.C)
          tma_store_2d(&map_y, out + c * kRegion, n0 + c0 + 64 * c, r0);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait_read<0>();

  // The block's partial: across the lane pairs of a column (gid ^ 2, gid
  // ^ 4), then the warps in order, in the staging memory (no store reads
  // it any more).
#pragma unroll
  for (int off = 8; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
    }
  named_barrier(kSyncConsumers, 256);
  float* red = reinterpret_cast<float*>(smem + a.stg_off);  // [8][2][NW]
  if (gid < 2) {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = 8 * j + 2 * tig + odd;
      red[(warp * 2 + 0) * NW + col] = s1[j];
      red[(warp * 2 + 1) * NW + col] = s2[j];
    }
  }
  named_barrier(kSyncConsumers, 256);
  const int tid = threadIdx.x;
  for (int v = tid; v < 2 * kChunk; v += 256) {
    const int stat = v / kChunk, col = v % kChunk;
    const int w0 = COLS ? 4 * (col / NW) : 0;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < (COLS ? 4 : 8); ++w)
      total += red[((w0 + w) * 2 + stat) * NW + col % NW];
    if (n0 + col < a.C)
      a.partial[((size_t)slot * 2 + stat) * a.C + n0 + col] = total;
  }
  named_barrier(kSyncConsumers, 256);
  if (tid == 0) *flag = arrive_last(a.counter, gridDim.x);
  named_barrier(kSyncConsumers, 256);
  if (!*flag) return;
  merge_partials(a.partial, a.stats, a.slots, 2 * a.C, tid, red,
                 [] { named_barrier(kSyncConsumers, 256); });
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, the same schedule and merge
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;
constexpr int kSimtBM = 64;  // rows of a tile
constexpr int kSimtBN = 64;  // columns of a chunk
constexpr int kSimtBK = 16;  // reduction depth per step

// Thread (tx, ty) of 16 x 16 owns rows ty + 16 i and columns tx + 16 j of
// each 64 x 64 tile of its chunk, i, j < 4.
__global__ void __launch_bounds__(kSimtThreads, 5) bn_matmul_simt_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ y, float* __restrict__ partial,
    float* __restrict__ stats, unsigned* __restrict__ counter, int N, int K,
    int C, int flags, int slots) {
  __shared__ float a_s[kSimtBK * kSimtBM];  // [k][m], the prologue applied
  __shared__ float b_s[kSimtBK * kSimtBN];  // [k][n]
  __shared__ float red[2][16][kSimtBN];     // [stat][ty][column]; merge
  __shared__ int is_last;
  const int n_chunks = (C + kSimtBN - 1) / kSimtBN;
  const int n_tiles = (N + kSimtBM - 1) / kSimtBM;
  const int slot = blockIdx.x / n_chunks;
  const int n0 = blockIdx.x % n_chunks * kSimtBN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s1[4] = {}, s2[4] = {};
  for (int t = slot; t < n_tiles; t += slots) {
    const int r0 = t * kSimtBM;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += kSimtBK) {
      __syncthreads();
      for (int i = threadIdx.x; i < kSimtBM * kSimtBK; i += kSimtThreads) {
        const int r = i / kSimtBK;
        const int k = i - r * kSimtBK;
        float v = 0.f;
        if (r0 + r < N && k0 + k < K) {
          v = x[(size_t)(r0 + r) * K + k0 + k];
          if (flags & kAffine)
            v = __fadd_rn(__fmul_rn(v, scale[k0 + k]), bias[k0 + k]);
          if (flags & kRelu) v = fmaxf(v, 0.f);
        }
        a_s[k * kSimtBM + r] = v;
      }
      for (int i = threadIdx.x; i < kSimtBK * kSimtBN; i += kSimtThreads) {
        const int k = i / kSimtBN;
        const int n = i - k * kSimtBN;
        b_s[i] = (k0 + k < K && n0 + n < C)
                     ? w[(size_t)(k0 + k) * C + n0 + n]
                     : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSimtBK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[k * kSimtBM + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[k * kSimtBN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
      if (r >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c >= C) continue;
        y[(size_t)r * C + c] = acc[i][j];
        s1[j] += acc[i][j];
        s2[j] = fmaf(acc[i][j], acc[i][j], s2[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx + 16 * j] = s1[j];
    red[1][ty][tx + 16 * j] = s2[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kSimtBN) {
    const int stat = threadIdx.x / kSimtBN;
    const int col = threadIdx.x % kSimtBN;
    float total = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) total += red[stat][t][col];
    if (n0 + col < C)
      partial[((size_t)slot * 2 + stat) * C + n0 + col] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) is_last = arrive_last(counter, gridDim.x);
  __syncthreads();
  if (!is_last) return;
  merge_partials(partial, stats, slots, 2 * C, threadIdx.x, &red[0][0][0],
                 [] { __syncthreads(); });
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

template <int NW, bool COLS>
int launch_wgmma(const void* x, const void* w, void* y, BnArgs a, int grid,
                 cudaStream_t st) {
  constexpr int kTileRows = COLS ? 64 : 128;
  constexpr int kChunk = COLS ? 2 * NW : NW;
  constexpr uint32_t kXBytes = kTileRows * 128;
  constexpr uint32_t kWSlice = kChunk * 128;
  int device = 0, max_smem = 0;
  int err = (int)cudaGetDevice(&device);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err) return err;
  // Fixed: the alignment to 1024 bytes, scale and bias ([n_k][2][64]
  // fp32), the barriers and the last-block flag. Then, in order of need:
  // the ring (at least 4 stages), w's chunk resident where it fits beside
  // them (else a slice in every stage), two y staging buffers a warpgroup
  // where they fit beside 4 stages (else one), more stages up to
  // kRingBytes.
  const uint32_t stg1 = 2 * (NW / 64) * kRegion;  // both warpgroups, once
  const uint32_t sb = a.n_k * 2 * kSliceK * 4;
  const uint32_t fixed = 1024 + sb + (2 * kMaxStages + 2) * 8;
  const uint32_t w_bytes = a.n_k * kWSlice;
  const uint32_t cap = (uint32_t)max_smem;
  a.resident = fixed + stg1 + w_bytes + 4 * kXBytes <= cap;
  a.stage_bytes = kXBytes + (a.resident ? 0 : kWSlice);
  const uint32_t base = fixed + (a.resident ? w_bytes : 0);
  a.stg_bufs = base + 2 * stg1 + 4 * a.stage_bytes <= cap ? 2 : 1;
  const uint32_t room = cap - base - a.stg_bufs * stg1;
  a.stages = min(min(kMaxStages, (int)(kRingBytes / a.stage_bytes)),
                 (int)(room / a.stage_bytes));
  if (a.stages < 2) return (int)cudaErrorInvalidValue;
  a.w_off = a.stages * a.stage_bytes;
  a.stg_off = a.w_off + (a.resident ? w_bytes : 0);
  a.sb_off = a.stg_off + a.stg_bufs * stg1;
  a.bar_off = a.sb_off + sb;
  const size_t smem = 1024 + a.bar_off + (2 * kMaxStages + 2) * 8;
  CUtensorMap mx, mw, my;
  const int dx[2] = {a.K, a.N}, dw[2] = {a.C, a.K}, dy[2] = {a.C, a.N};
  if ((err = encode_bf16_map(&mx, x, 2, dx, kTileRows))) return err;
  if ((err = encode_bf16_map(&mw, w, 2, dw, 64))) return err;
  if ((err = encode_bf16_map(&my, y, 2, dy, 64))) return err;
  err = (int)cudaFuncSetAttribute(bn_matmul_wgmma_kernel<NW, COLS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  bn_matmul_wgmma_kernel<NW, COLS>
      <<<grid, kWgThreads, smem, st>>>(mx, mw, my, a);
  return (int)cudaGetLastError();
}

}  // namespace

// y [N, C] (x's dtype) = prologue(x [N, K]) @ w [K, C]; stats [2, C] fp32 =
// column sums and sums of squares of the fp32 product. scale and bias: fp32
// [K], read only when flags has bit 0 (affine); bit 1 = ReLU. dtype: 0 =
// float32 (chunk 64, 64-row tiles), 1 = bfloat16 (K and C multiples of 8;
// chunk 64 or 128 with 128-row tiles, 256 with 64-row tiles). The grid is
// slots x ceil(C / chunk) persistent blocks; partial: fp32 workspace of
// slots x 2 x C; counter: one uint32, zero, left zero. Returns the
// cudaError_t of the launch.
extern "C" int pdtx_bn_matmul(const void* x, const void* w, const void* scale,
                              const void* bias, void* y, void* partial,
                              void* stats, void* counter, int N, int K, int C,
                              int flags, int dtype, int chunk, int slots,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || K < 1 || C < 1 || slots < 1) return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + chunk - 1) / chunk;
  const int grid = slots * n_chunks;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(stats);
  unsigned* cnt = static_cast<unsigned*>(counter);
  if (dtype == 0) {
    if (chunk != kSimtBN) return (int)cudaErrorInvalidValue;
    bn_matmul_simt_kernel<<<grid, kSimtThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, bi,
        static_cast<float*>(y), part, out, cnt, N, K, C, flags, slots);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || K % 8 || C % 8) return (int)cudaErrorInvalidValue;
  const int rows = chunk == 256 ? 64 : 128;
  BnArgs a{sc, bi, part, out, cnt, N, K, C, flags, n_chunks, slots,
           (N + rows - 1) / rows, (K + kSliceK - 1) / kSliceK};
  if (chunk == 64) return launch_wgmma<64, false>(x, w, y, a, grid, st);
  if (chunk == 128) return launch_wgmma<128, false>(x, w, y, a, grid, st);
  if (chunk == 256) return launch_wgmma<128, true>(x, w, y, a, grid, st);
  return (int)cudaErrorInvalidValue;
}
