// Ragged grouped expert matmul for Hopper (sm_90a), plain C interface for
// ctypes: the dropless MoE's expert products and their weight gradient.
//
// Replaces the Pallas TPU kernels of pytorch_distributed_training_example_tpu/
// ops/grouped_matmul.py:
// - `_gmm_kernel` (via `_gmm_call`): out[r] = x[r] @ w[e] for every row r of
//   expert e's contiguous segment [starts[e], starts[e] + counts[e]) of the
//   expert-sorted rows, fp32 accumulation, output in x's dtype. The
//   backward's dx is the same product against w[e] transposed, which this
//   kernel reads in place (`trans_w`), never from a transposed copy.
// - `_gmm_dw_kernel` (via `_gmm_dw_call`): dw[e] = sum over e's segment of
//   x_r^T dout_r in fp32, zero for an empty expert.
//
// What bounds them on this card: tensor-core operations. At the llama_moe
// shape (kT = 16384 routed rows, d = 1024, f = 2048) each launch does
// 2 kT d f = 6.87e10 flops on ~0.1 GB, ~700 flops a byte, far above the
// H100's ~295 flop/byte balance point: the least time is the flops over the
// 989 TF/s bf16 dense peak, 0.069 ms.
//
// What the design does about it (bf16):
// - wgmma (hopper.cuh) fed by a ring of TMA stages, warp-specialised and
//   persistent: one block an SM of two consumer warpgroups, 64 tile rows
//   each, and one producer warpgroup (setmaxnreg moves its registers to the
//   consumers) whose one thread keeps the ring full. A stage is a 64-deep
//   slice of the reduction: A (128 rows) and B (256 columns) in 128-byte
//   swizzled boxes, full/empty mbarriers between the two sides. The ring
//   runs on across work items, so the next item's loads overlap this
//   item's last products and its stores.
// - Both operands are read in place in their stored majors: x K-major and w
//   MN-major for the forward, w K-major for trans_w; for dw, x^T and dout
//   both MN-major. w is mapped 3-D ([E, K, N] or [E, N, K]), so a slice
//   past K reads zeros, never expert e + 1's weights.
// - The gmm work items are (128-row tile, 256-column tile) pairs in expert
//   order, the row tiles derived on the card from the counts (no host sync
//   sizes the grid), the column tiles of one row tile adjacent, so the
//   blocks in flight share a few row tiles of x and one expert's w in L2.
//   256 columns read A once for twice the work of 128 (128 x 128 tiles
//   ran slower at every llama_moe shape). A tile's rows past its segment
//   are the next expert's: their products are discarded and the stores
//   are guarded to the segment, so each output row depends only on its own
//   row and its expert's weights, bitwise, wherever it falls in a tile.
// - Stores are staged through shared memory (16-byte row chunks, swizzled),
//   so a warp writes whole rows; from the accumulator's own layout a
//   warp's stores scatter over 8 rows, and took several times as long.
// - dw: a small planning kernel cuts every segment into row chunks (one
//   chunk below 2 kDwChunk rows; above, floor(rows / kDwChunk) chunks of
//   equal size) and orders them heaviest first, so that a heavy expert's
//   tiles do not set the tail. A work item is (chunk, 128 x 256 dw tile).
//   The rows past a chunk's end in its last slice are zeroed in shared
//   memory before the products. An unsplit expert writes its tile once; a
//   split one writes fp32 partials to the workspace, and the chunk that
//   arrives last (an integer counter) sums them in chunk order. No float
//   atomics: dw is bitwise reproducible. An empty expert's tiles are zeros.
// - fp32 keeps fp32 products (the tensor cores would round them to TF32)
//   and runs on the CUDA cores from a 4 x 4 register tile per thread.

#include "hopper.cuh"

namespace {

using namespace pdtx;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // the fp32 kernels' blocks
constexpr int kBM = 128;       // rows of a gmm row tile (both dtypes)

// The row tile `tile` of the expert-sorted rows: its expert and its rows
// [r0, r1). False past the last segment's last tile.
__device__ __forceinline__ bool find_tile(const int* __restrict__ starts,
                                          const int* __restrict__ counts,
                                          int E, int tile, int* e_out, int* r0,
                                          int* r1) {
  for (int e = 0; e < E; ++e) {
    const int c = counts[e];
    const int n = (c + kBM - 1) / kBM;
    if (tile < n) {
      *e_out = e;
      *r0 = starts[e] + tile * kBM;
      *r1 = starts[e] + c;
      return true;
    }
    tile -= n;
  }
  return false;
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring, warp-specialised, persistent
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // two consumer warpgroups + the producer
// Registers a thread after the split: 40 * 128 + 232 * 256 of the 65,536.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kSliceK = 64;  // depth of a stage: one 128-byte swizzled row
constexpr uint32_t kABytes = kBM * kSliceK * 2;         // 16 KB: A, 128 rows
constexpr uint32_t kRegionBytes = 64 * kSliceK * 2;    // a 64 x 64 box, 8 KB
constexpr int kBN = 256;      // tile columns
constexpr int kDwChunk = 4096;  // dw: segments of 2 kDwChunk rows and more
                                // are split into chunks of this size or more
constexpr int kPlanFields = 6;  // a dw chunk: e, k0, k1, j, n, slot
constexpr uint32_t kOutBytes = 64 * 256;  // a warpgroup's output staging

// Shared memory: the ring's 4 stages of 48 KB, the two warpgroups' output
// staging, the ring's barriers, dw's "last chunk" flag: 230,480 bytes of
// the 232,448 a block may take.
constexpr int kStages = 4;
constexpr uint32_t kStageBytes = kABytes + kBN * kSliceK * 2;
constexpr uint32_t kOutOffset = kStages * kStageBytes;
constexpr size_t kSmem = 1024 + kOutOffset + 2 * kOutBytes +
                         2 * kStages * sizeof(uint64_t) + 16;

// The ring's barriers after its stages: full (the producer's arrival and
// the TMA bytes) and empty (one arrival a consumer warp).
__device__ __forceinline__ uint64_t* ring_barriers(unsigned char* smem) {
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kOutOffset + 2 * kOutBytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[kStages + s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return full;
}

// acc (+)= A B over one stage's 64-deep slice: the warpgroup's 64 rows of
// A at a, all 256 columns of B at b; TA, TB the operands' majors (0
// K-major, 1 MN-major, hopper.cuh). accumulate 0 overwrites acc.
template <int TA, int TB>
__device__ __forceinline__ void mma_slice(float (&acc)[kBN / 2], uint32_t a,
                                          uint32_t b, int accumulate) {
  const uint64_t ad = TA ? mnmajor_desc(a, kSliceK) : kmajor_desc(a);
  const uint64_t bd = TB ? mnmajor_desc(b, kSliceK) : kmajor_desc(b);
#pragma unroll
  for (int kk = 0; kk < kSliceK / 16; ++kk)
    wgmma_ss<kBN, TA, TB>(
        acc, ad + (TA ? mnmajor_step(kk) : kmajor_step(kBM, kk)),
        bd + (TB ? mnmajor_step(kk) : kmajor_step(kBN, kk)),
        accumulate | kk);
}

// A consumer warpgroup's share of one work item: its n_k slices, taken from
// the ring in order (`it` counts stages across items, as the producer's
// does), acc = the sum of their products. edit(stage, ks) runs after a
// stage has landed and before its products (dw's row mask). One wgmma
// group stays in flight; a stage is freed once its group has completed.
template <int TA, int TB, typename Edit>
__device__ __forceinline__ void consume(float (&acc)[kBN / 2],
                                        unsigned char* smem, uint64_t* full,
                                        int wg, int lane, int n_k, int& it,
                                        Edit edit) {
  uint64_t* empty = full + kStages;
  for (int ks = 0; ks < n_k; ++ks, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    edit(s, ks);
    const uint32_t stage = opaque(smem_u32(smem)) + s * kStageBytes;
    reg_fence(acc);
    wgmma_fence();
    mma_slice<TA, TB>(acc, stage + wg * kRegionBytes, stage + kABytes,
                      ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(acc);
    if (ks > 0) warp_arrive(&empty[(it - 1) % kStages], lane);
  }
  wgmma_wait<0>();
  reg_fence(acc);
  if (n_k > 0) warp_arrive(&empty[(it - 1) % kStages], lane);
}

// The warpgroup's m64n256 accumulator into rows row0..row0 + 63 (those at
// or past r_end skipped) and columns n0.. (those at or past N skipped) of
// the row-major [*, N] matrix out, as T (bf16 rounded once, or fp32).
// Staged through the warpgroup's kOutBytes of shared memory, 256 bytes of
// each row a pass, the 16-byte chunks of a row swizzled by the row (chunk
// c at c ^ (row % 8)), so that neither the accumulator's writes nor the
// row reads meet a bank conflict; then written 16 bytes a thread, a row's
// bytes by neighbouring threads.
template <typename T>
__device__ __forceinline__ void store_tile(T* out, int N, int row0,
                                           int r_end, int n0,
                                           unsigned char* staging, int wg,
                                           const float (&c)[kBN / 2]) {
  constexpr int kCols = 256 / sizeof(T);  // columns a pass
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int p = 0; p < kBN / kCols; ++p) {
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
      const int j = p * kCols / 8 + jj;
      const int byte = (8 * jj + 2 * tig) * (int)sizeof(T);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + gid + 8 * h;  // r % 8 == gid
        unsigned char* dst =
            staging + r * 256 + ((byte / 16) ^ gid) * 16 + byte % 16;
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<uint32_t*>(dst) =
              pack_bf16(c[4 * j + 2 * h], c[4 * j + 2 * h + 1]);
        else
          *reinterpret_cast<float2*>(dst) =
              make_float2(c[4 * j + 2 * h], c[4 * j + 2 * h + 1]);
      }
    }
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < 64 * 16 / 128; ++i) {
      const int r = (t + 128 * i) / 16, chunk = (t + 128 * i) % 16;
      const int col = n0 + p * kCols + chunk * (16 / (int)sizeof(T));
      if (row0 + r < r_end && col < N)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + col) =
            *reinterpret_cast<const uint4*>(staging + r * 256 +
                                            (chunk ^ (r % 8)) * 16);
    }
    named_barrier(1 + wg, 128);
  }
}

// ----- gmm -----

struct GmmArgs {
  const int* starts;
  const int* counts;
  bf16* out;  // [Tk, N]
  int E, K, N;
};

// Work item i: row tile i / n_ct of the expert-sorted rows (from the
// counts), column tile i % n_ct, and its slices; false past the last row
// tile.
struct GmmItem {
  int e, r0, r1, n0, n_k;
  __device__ __forceinline__ bool find(const GmmArgs& a, int i) {
    const int n_ct = (a.N + kBN - 1) / kBN;
    n0 = i % n_ct * kBN;
    n_k = (a.K + kSliceK - 1) / kSliceK;
    return find_tile(a.starts, a.counts, a.E, i / n_ct, &e, &r0, &r1);
  }
};

// out = x @ w[e] over the segments. map_x: x [Tk, K], boxes of 128 rows;
// map_w: w [E, K, N] in 64-row boxes, or [E, N, K] in 256-row boxes when
// TRANS_W.
template <int TRANS_W>
__global__ void __launch_bounds__(kWgThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const GmmArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = ring_barriers(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  GmmItem w;

  if (warp >= 8) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    uint64_t* empty = full + kStages;
    int it = 0;
    for (int i = blockIdx.x; w.find(a, i); i += gridDim.x) {
      // w's 64-column boxes wholly past N hold nothing a store keeps: not
      // loaded (their stale columns are never stored).
      const int nb = TRANS_W ? 0 : min(kBN / 64, (a.N - w.n0 + 63) / 64);
      const uint32_t bytes =
          kABytes + (TRANS_W ? kBN * kSliceK * 2 : nb * kRegionBytes);
      for (int ks = 0; ks < w.n_k; ++ks, ++it) {
        const int s = it % kStages;
        unsigned char* st = smem + s * kStageBytes;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], bytes);
        tma_load_2d(st, &map_x, &full[s], ks * kSliceK, w.r0);
        if (TRANS_W)
          tma_load_3d(st + kABytes, &map_w, &full[s], ks * kSliceK, w.n0,
                      w.e);
        for (int c = 0; c < nb; ++c)
          tma_load_3d(st + kABytes + c * kRegionBytes, &map_w, &full[s],
                      w.n0 + 64 * c, ks * kSliceK, w.e);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  int it = 0;
  for (int i = blockIdx.x; w.find(a, i); i += gridDim.x) {
    float acc[kBN / 2] = {};  // not live from the last item on
    consume<0, TRANS_W ? 0 : 1>(acc, smem, full, wg, lane, w.n_k, it,
                                [](int, int) {});
    store_tile(a.out, a.N, w.r0 + 64 * wg, w.r1, w.n0,
               smem + kOutOffset + wg * kOutBytes, wg, acc);
  }
}

// ----- gmm_dw -----

struct DwArgs {
  const int* plan;  // [1 + kPlanFields * chunks]: the chunk count, chunks
  int* counters;    // [E, tiles]: arrivals of a split expert's chunks
  float* dw;        // [E, M, N]
  float* partial;   // [slots, M, N]: a split expert's chunk partials
  int M, N;
};

// The dw schedule: every segment as row chunks, heaviest first (ties in
// expert order), into plan, worked out by one thread from the counts
// staged in shared memory ([2, E] ints); the counters zeroed. A chunk is e,
// its rows [k0, k1), its index j of the expert's n, and the expert's first
// partial slot (-1 unless split). Below 2 kDwChunk rows a segment is one
// chunk (an empty one too: its tiles are written as zeros); above, its rows
// are cut into n = floor(rows / kDwChunk) (fewer where whole slices leave
// the last one empty) equal chunks of fewer than 2 kDwChunk rows.
__global__ void gmm_dw_plan_kernel(const int* __restrict__ starts,
                                   const int* __restrict__ counts, int E,
                                   int* __restrict__ plan,
                                   int* __restrict__ counters,
                                   int n_counters) {
  constexpr int kBuckets = 2 * kDwChunk / kSliceK + 1;  // chunk slices
  __shared__ int first[kBuckets];
  extern __shared__ int seg[];
  int* start = seg;
  int* count = seg + E;
  for (int i = threadIdx.x; i < n_counters; i += blockDim.x) counters[i] = 0;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    start[e] = starts[e];
    count[e] = counts[e];
  }
  for (int b = threadIdx.x; b < kBuckets; b += blockDim.x) first[b] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;
  auto chunk_rows = [](int c) {  // rows of each chunk but the last
    const int n = c < 2 * kDwChunk ? 1 : c / kDwChunk;
    return ((c + n - 1) / n + kSliceK - 1) / kSliceK * kSliceK;
  };
  auto slices = [](int rows) { return (rows + kSliceK - 1) / kSliceK; };
  int n_chunks = 0;
  for (int e = 0; e < E; ++e) {
    const int c = count[e], s = chunk_rows(c);
    for (int j = 0; j * s < c || j == 0; ++j, ++n_chunks)
      ++first[slices(min(s, c - j * s))];
  }
  for (int b = kBuckets - 1, pos = 0; b >= 0; --b) {
    const int t = first[b];
    first[b] = pos;
    pos += t;
  }
  for (int e = 0, slot = 0; e < E; ++e) {
    const int c = count[e], s = chunk_rows(c);
    const int n = c > s ? (c + s - 1) / s : 1;
    for (int j = 0; j < n; ++j) {
      const int k0 = start[e] + j * s;
      const int k1 = start[e] + min(c, (j + 1) * s);
      int* q = plan + 1 + kPlanFields * first[slices(min(s, c - j * s))]++;
      q[0] = e;
      q[1] = k0;
      q[2] = k1;
      q[3] = j;
      q[4] = n;
      q[5] = n > 1 ? slot : -1;
    }
    if (n > 1) slot += n;
  }
  plan[0] = n_chunks;
}

// Work item i: chunk i / tiles of the plan, dw tile i % tiles.
struct DwItem {
  int e, k0, k1, j, n, slot, tile, m0, n0, n_k;
  __device__ __forceinline__ DwItem(const DwArgs& a, int i) {
    const int n_nt = (a.N + kBN - 1) / kBN;
    const int tiles = (a.M + kBM - 1) / kBM * n_nt;
    const int* q = a.plan + 1 + kPlanFields * (i / tiles);
    e = q[0];
    k0 = q[1];
    k1 = q[2];
    j = q[3];
    n = q[4];
    slot = q[5];
    tile = i % tiles;
    m0 = tile / n_nt * kBM;
    n0 = tile % n_nt * kBN;
    n_k = (k1 - k0 + kSliceK - 1) / kSliceK;
  }
};

// The n partials of a split tile summed in chunk order into dw_e: rows
// [m0, m0 + 128) and columns [n0, n0 + 256), clipped to [M, N], read from
// L2 (written by other blocks) as float4s, a row's by neighbouring
// threads. Two partials of 8 float4s at a time keep 16 loads in flight a
// thread, and spill nothing.
__device__ __forceinline__ void sum_partials(float* dw_e, const float* part,
                                             int n, int M, int N, int m0,
                                             int n0, int t) {
  constexpr int kVecs = 8;  // rows a thread a batch, 4 apart
  const int c = t % 64 * 4;  // the thread's column in the tile
  const bool col_in = n0 + c < N;
  const size_t slot_stride = (size_t)M * N;
  auto load = [&](const float* p, int r0, float4 (&x)[kVecs]) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      x[v] = col_in && m0 + r0 + 4 * v < M
                 ? __ldcg(reinterpret_cast<const float4*>(
                       p + (size_t)4 * v * N))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto add = [](float4 (&s)[kVecs], const float4 (&x)[kVecs]) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      s[v].x += x[v].x;
      s[v].y += x[v].y;
      s[v].z += x[v].z;
      s[v].w += x[v].w;
    }
  };
#pragma unroll 1
  for (int r0 = t / 64; r0 < kBM; r0 += 4 * kVecs) {
    const size_t at = (size_t)(m0 + r0) * N + n0 + c;
    float4 s[kVecs], x0[kVecs], x1[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) s[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    int q = 0;
    for (; q + 1 < n; q += 2) {
      load(part + q * slot_stride + at, r0, x0);
      load(part + (q + 1) * slot_stride + at, r0, x1);
      add(s, x0);
      add(s, x1);
    }
    if (q < n) {
      load(part + q * slot_stride + at, r0, x0);
      add(s, x0);
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      if (col_in && m0 + r0 + 4 * v < M)
        *reinterpret_cast<float4*>(dw_e + at + (size_t)4 * v * N) = s[v];
  }
}

// dw[e] = x[seg]^T dout[seg] over the plan's chunks. map_x: x [Tk, M],
// map_dout: dout [Tk, N], both in 64 x 64 boxes.
__global__ void __launch_bounds__(kWgThreads, 1)
    gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_dout,
                        const DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = ring_barriers(smem);
  int* last = reinterpret_cast<int*>(full + 2 * kStages);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (a.M + kBM - 1) / kBM * ((a.N + kBN - 1) / kBN);
  const int n_items = a.plan[0] * tiles;

  if (warp >= 8) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    uint64_t* empty = full + kStages;
    int it = 0;
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      if (work_of(r) >= n_items) continue;
      const DwItem w(a, work_of(r));
      // Boxes wholly past M or N: not loaded (never stored).
      const int na = min(2, (a.M - w.m0 + 63) / 64);
      const int nb = min(kBN / 64, (a.N - w.n0 + 63) / 64);
      for (int ks = 0; ks < w.n_k; ++ks, ++it) {
        const int s = it % kStages;
        unsigned char* st = smem + s * kStageBytes;
        const int row = w.k0 + ks * kSliceK;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], (na + nb) * kRegionBytes);
        for (int c = 0; c < na; ++c)
          tma_load_2d(st + c * kRegionBytes, &map_x, &full[s], w.m0 + 64 * c,
                      row);
        for (int c = 0; c < nb; ++c)
          tma_load_2d(st + kABytes + c * kRegionBytes, &map_dout, &full[s],
                      w.n0 + 64 * c, row);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4, t = threadIdx.x;
  unsigned char* staging = smem + kOutOffset + wg * kOutBytes;
  int it = 0;
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    if (work_of(r) >= n_items) continue;
    const DwItem w(a, work_of(r));
    // Zeros for an empty expert; and acc is not live from the last item on
    // (wgmma reads it), through the split sum's registers.
    float acc[kBN / 2] = {};
    // The last slice's rows past the chunk (the next chunk's or expert's,
    // which TMA cannot mask) are zeroed in this warpgroup's A region.
    consume<1, 1>(acc, smem, full, wg, lane, w.n_k, it,
                  [&](int s, int ks) {
      const int valid = w.k1 - w.k0 - ks * kSliceK;
      if (valid >= kSliceK) return;
      uint4* rows = reinterpret_cast<uint4*>(
          smem + s * kStageBytes + wg * kRegionBytes + valid * 128);
      for (int v = t % 128; v < (kSliceK - valid) * 8; v += 128)
        rows[v] = make_uint4(0u, 0u, 0u, 0u);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
    });
    float* dw_e = a.dw + (size_t)w.e * a.M * a.N;
    if (w.slot < 0) {
      store_tile(dw_e, a.N, w.m0 + 64 * wg, a.M, w.n0, staging, wg, acc);
      continue;
    }
    // A split expert: this chunk's partial into its slot; the chunk that
    // arrives last sums the expert's n partials.
    float* part = a.partial + (size_t)w.slot * a.M * a.N;
    store_tile(part + (size_t)w.j * a.M * a.N, a.N, w.m0 + 64 * wg, a.M,
               w.n0, staging, wg, acc);
    // One thread releases the block's writes and counts the arrival (the
    // barrier orders the other threads' writes before its fence), and
    // acquires the other chunks' partials for the block.
    named_barrier(3, 256);
    if (t == 0) {
      __threadfence();
      *last = atomicAdd(&a.counters[w.e * tiles + w.tile], 1) == w.n - 1;
      __threadfence();
    }
    named_barrier(3, 256);
    if (*last) sum_partials(dw_e, part, w.n, a.M, a.N, w.m0, w.n0, t);
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores (exact fp32 products)
// ---------------------------------------------------------------------------

constexpr int kSimtBM = 64;  // output rows per block
constexpr int kSimtBN = 64;  // output columns per block
constexpr int kSimtBK = 16;  // reduction depth per step
// 256 threads as 16 x 16; thread (tx, ty) owns rows ty + 16 i and columns
// tx + 16 j, i, j < 4, so a step's shared reads are broadcasts or
// consecutive.

// The 4 x 4 register tile's k step over [kSimtBK][64] shared tiles a_s
// (a_s[k][m]) and b_s (b_s[k][n]).
__device__ __forceinline__ void simt_step(float (&acc)[4][4], const float* a_s,
                                          const float* b_s, int tx, int ty) {
#pragma unroll
  for (int k = 0; k < kSimtBK; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_s[k * kSimtBM + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = b_s[k * kSimtBN + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int TRANS_W>
__global__ void __launch_bounds__(kThreads) gmm_simt_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ counts,
    float* __restrict__ out, int E, int K, int N) {
  __shared__ float a_s[kSimtBK * kSimtBM];
  __shared__ float b_s[kSimtBK * kSimtBN];
  // Row tiles are kBM rows (the grid is the bf16 kernel's); each block
  // covers one kSimtBM sub-tile of its row tile, blockIdx.z.
  int e, r0, r1;
  if (!find_tile(starts, counts, E, blockIdx.y, &e, &r0, &r1)) return;
  r0 += blockIdx.z * kSimtBM;
  if (r0 >= r1) return;
  const int n0 = blockIdx.x * kSimtBN;
  const float* w_e = w + (size_t)e * K * N;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSimtBK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtBM * kSimtBK; i += kThreads) {
      const int r = i / kSimtBK;
      const int k = i - r * kSimtBK;
      a_s[k * kSimtBM + r] = (r0 + r < r1 && k0 + k < K)
                                 ? x[(size_t)(r0 + r) * K + k0 + k]
                                 : 0.f;
    }
    for (int i = threadIdx.x; i < kSimtBK * kSimtBN; i += kThreads) {
      float v = 0.f;
      if (TRANS_W) {  // w_e [N, K]
        const int n = i / kSimtBK;
        const int k = i - n * kSimtBK;
        if (n0 + n < N && k0 + k < K) v = w_e[(size_t)(n0 + n) * K + k0 + k];
        b_s[k * kSimtBN + n] = v;
      } else {        // w_e [K, N]
        const int k = i / kSimtBN;
        const int n = i - k * kSimtBN;
        if (k0 + k < K && n0 + n < N) v = w_e[(size_t)(k0 + k) * N + n0 + n];
        b_s[k * kSimtBN + n] = v;
      }
    }
    __syncthreads();
    simt_step(acc, a_s, b_s, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= r1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) gmm_dw_simt_kernel(
    const float* __restrict__ x, const float* __restrict__ dout,
    const int* __restrict__ starts, const int* __restrict__ counts,
    float* __restrict__ dw, int M, int N) {
  __shared__ float a_s[kSimtBK * kSimtBM];
  __shared__ float b_s[kSimtBK * kSimtBN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kSimtBM;
  const int n0 = blockIdx.x * kSimtBN;
  const int re = starts[e] + counts[e];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int k0 = starts[e]; k0 < re; k0 += kSimtBK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtBK * kSimtBM; i += kThreads) {
      const int k = i / kSimtBM;
      const int m = i - k * kSimtBM;
      a_s[i] = (k0 + k < re && m0 + m < M) ? x[(size_t)(k0 + k) * M + m0 + m]
                                           : 0.f;
      b_s[i] = (k0 + k < re && n0 + m < N)
                   ? dout[(size_t)(k0 + k) * N + n0 + m]
                   : 0.f;
    }
    __syncthreads();
    simt_step(acc, a_s, b_s, tx, ty);
  }
  float* dw_e = dw + (size_t)e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) dw_e[(size_t)r * N + c] = acc[i][j];
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

template <int TRANS_W>
int launch_gmm_bf16(const void* x, const void* w, const int* starts,
                    const int* counts, void* out, int Tk, int E, int K, int N,
                    cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  const int x_dims[2] = {K, Tk};
  const int w_dims[3] = {TRANS_W ? K : N, TRANS_W ? N : K, E};
  int sms = 0;
  int err = encode_bf16_map(&map_x, x, 2, x_dims, kBM);
  if (!err)
    err = encode_bf16_map(&map_w, w, 3, w_dims, TRANS_W ? kBN : kSliceK);
  if (!err) err = sm_count(&sms);
  if (!err) err = set_smem(gmm_wgmma_kernel<TRANS_W>, kSmem);
  if (err) return err;
  // At most ceil(Tk / 128) + E row tiles; the blocks past the last item
  // find none and exit.
  const long long items =
      (long long)((Tk + kBM - 1) / kBM + E) * ((N + kBN - 1) / kBN);
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  gmm_wgmma_kernel<TRANS_W><<<grid, kWgThreads, kSmem, stream>>>(
      map_x, map_w, GmmArgs{starts, counts, static_cast<bf16*>(out), E, K, N});
  return (int)cudaGetLastError();
}

template <int TRANS_W>
int launch_gmm_f32(const void* x, const void* w, const int* starts,
                   const int* counts, void* out, int row_tiles, int E, int K,
                   int N, cudaStream_t stream) {
  dim3 grid((N + kSimtBN - 1) / kSimtBN, row_tiles, kBM / kSimtBM);
  gmm_simt_kernel<TRANS_W><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), starts,
      counts, static_cast<float*>(out), E, K, N);
  return (int)cudaGetLastError();
}

// The bf16 dw workspace: the plan, the split counters, then the partial
// slots (a split expert's n chunks take n slots; the splits of all experts
// take at most Tk / kDwChunk), each at a 256-byte boundary.
struct DwWorkspace {
  int tiles;
  size_t counters, partial, bytes;
  DwWorkspace(int Tk, int E, int M, int N) {
    auto align = [](size_t b) { return (b + 255) / 256 * 256; };
    tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
    const size_t chunks = (size_t)E + Tk / kDwChunk;
    counters = align(sizeof(int) * (1 + kPlanFields * chunks));
    partial = align(counters + sizeof(int) * (size_t)E * tiles);
    bytes = partial + sizeof(float) * (size_t)(Tk / kDwChunk) * M * N;
  }
};

}  // namespace

// out [Tk, N] = x [Tk, K] @ w[e] over the expert segments (starts, counts:
// int32 [E] on the card, segments tiling [0, Tk) in expert order). w is
// [E, K, N], or [E, N, K] read transposed when trans_w. dtype: 0 = float32,
// 1 = bfloat16; K and N multiples of 8 for bfloat16. Returns the
// cudaError_t of the launch.
extern "C" int pdtx_gmm(const void* x, const void* w, const void* starts,
                        const void* counts, void* out, int Tk, int E, int K,
                        int N, int trans_w, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  if (dtype == 1) {
    if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
    if (Tk == 0) return 0;
    return trans_w ? launch_gmm_bf16<1>(x, w, st, ct, out, Tk, E, K, N, s)
                   : launch_gmm_bf16<0>(x, w, st, ct, out, Tk, E, K, N, s);
  }
  const int row_tiles = (Tk + kBM - 1) / kBM + E;
  if (dtype == 0)
    return trans_w
               ? launch_gmm_f32<1>(x, w, st, ct, out, row_tiles, E, K, N, s)
               : launch_gmm_f32<0>(x, w, st, ct, out, row_tiles, E, K, N, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of the workspace pdtx_gmm_dw takes (0 for float32).
extern "C" long long pdtx_gmm_dw_workspace(int Tk, int E, int M, int N,
                                           int dtype) {
  return dtype == 1 ? (long long)DwWorkspace(Tk, E, M, N).bytes : 0;
}

// dw [E, M, N] fp32 = per segment x[seg]^T @ dout[seg], x [Tk, M], dout
// [Tk, N]; every element written once (zeros for an empty expert).
// workspace: pdtx_gmm_dw_workspace bytes on the card, 256-byte aligned.
extern "C" int pdtx_gmm_dw(const void* x, const void* dout, const void* starts,
                           const void* counts, void* dw, void* workspace,
                           int Tk, int E, int M, int N, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  if (dtype == 1) {
    if (M % 8 || N % 8) return (int)cudaErrorInvalidValue;
    if (Tk == 0)
      return (int)cudaMemsetAsync(dw, 0, sizeof(float) * E * M * N, s);
    const DwWorkspace ws(Tk, E, M, N);
    unsigned char* base = static_cast<unsigned char*>(workspace);
    int* plan = reinterpret_cast<int*>(base);
    int* counters = reinterpret_cast<int*>(base + ws.counters);
    int err = 0;
    const size_t plan_smem = 2 * sizeof(int) * E;
    if (plan_smem > 48 * 1024) err = set_smem(gmm_dw_plan_kernel, plan_smem);
    if (err) return err;
    gmm_dw_plan_kernel<<<1, 256, plan_smem, s>>>(st, ct, E, plan, counters,
                                                 E * ws.tiles);
    err = (int)cudaGetLastError();
    CUtensorMap map_x, map_dout;
    const int x_dims[2] = {M, Tk}, dout_dims[2] = {N, Tk};
    if (!err) err = encode_bf16_map(&map_x, x, 2, x_dims, kSliceK);
    if (!err) err = encode_bf16_map(&map_dout, dout, 2, dout_dims, kSliceK);
    int sms = 0;
    if (!err) err = sm_count(&sms);
    if (!err) err = set_smem(gmm_dw_wgmma_kernel, kSmem);
    if (err) return err;
    const long long items = ((long long)E + Tk / kDwChunk) * ws.tiles;
    const unsigned grid = (unsigned)(items < sms ? items : sms);
    gmm_dw_wgmma_kernel<<<grid, kWgThreads, kSmem, s>>>(
        map_x, map_dout,
        DwArgs{plan, counters, static_cast<float*>(dw),
               reinterpret_cast<float*>(base + ws.partial), M, N});
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    dim3 grid((N + kSimtBN - 1) / kSimtBN, (M + kSimtBM - 1) / kSimtBM, E);
    gmm_dw_simt_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dout), st, ct,
        static_cast<float*>(dw), M, N);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
