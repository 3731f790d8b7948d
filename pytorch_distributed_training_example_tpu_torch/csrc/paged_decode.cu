// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (pytorch_distributed_training_example_tpu/ops/flash_attention.py:1037),
// launched by `_paged_decode_pallas`: one query token per request against
// K/V pages reached through a page table, GQA grouped per KV head (the G
// query heads of a KV head share each K/V row read), keys masked to
// `k_pos <= pos`, pages past `pos` never read, online softmax in fp32 and
// out = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on this card: bytes. A decode step reads every live K/V
// row once and does ~4 flops per byte read, far below the H100's ~295
// flop/byte balance point, so the least time is the live K/V bytes over
// 3.35 TB/s. At serving's batch sizes that is microseconds, so what the
// design has to buy is parallelism and bytes in flight, not flops.
//
// What the design does about it (bf16 at head_dim 64 and 128, G <= 16,
// pages of 16 tokens or more: every model's serving path):
// - Split-KV. A work item is (split, KV head, request); a split is
//   `pages_per_split` whole pages of the request's cache. The grid is sized
//   from what the host knows (B, Hkv, the table's width, the SM count; the
//   wrapper's `_paged_decode_splits` picks the split), never from the
//   positions, which stay on the card: a block reads its request's position
//   and its split's page ids together, and returns at once if the split
//   starts past the position.
// - A TMA ring per warp. The block's four warps take the split's 16-token
//   tiles in turn. A tile never crosses a page, so one lane of each warp
//   looks its page up (what the TPU kernel's scalar prefetch did) and
//   issues one TMA box a 64-column half of K and of V, 128-byte swizzled,
//   over a 3-D map of the pool (columns, KV heads, token rows), into its
//   own ring of up to two stages, each with its mbarrier. A warp waits only
//   on its own stages: no block-wide barrier per tile. Rows past the
//   request's last token are masked, and their V rows zeroed.
// - Tensor-core products, to remove the reductions, not to gain flops: the
//   tile's 16 tokens are the M rows of mma.sync m16n8k16 and the G query
//   heads its N columns (8, or 16 for G > 8, padded with zeros). S^T = K
//   Q^T with K through ldmatrix; P^T is rounded to bf16 and transposed in
//   registers (movmatrix) into the B operand of O^T += V^T P^T, V through
//   ldmatrix.trans, both reading the swizzled tiles without bank
//   conflicts. A head's max over a tile takes three shuffles; at G <= 8 a
//   thread holds 32 fp32 accumulators at head_dim 128.
// - A deterministic merge. The warps' softmax states merge in warp order
//   through shared memory. A request with one live split writes its output
//   there; otherwise each split writes (m, l, acc) in fp32 to the
//   workspace and counts its arrival with one acquire-release increment
//   (atom.inc wraps the last block's count back to 0 for the next call);
//   the block that arrives last merges the splits in split order, 8 at a
//   time, with no float atomics, so two calls give the same bits.
//
// Routing inside the C entry, by dtype, head_dim, G and page size: the case
// above (page sizes that are powers of two from 16 up) runs the split
// kernel; fp32 (exact fp32 products, which the tensor cores would round),
// bf16 at head_dim 256, G > 16 and other page sizes keep the first kernel
// of this file: one block per (request, KV head) walking the cache in 16 KB
// chunks of K and V, one thread per score and per four outputs, all
// arithmetic in fp32. Nothing falls back: a failed launch returns its
// error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite, as in the JAX kernels
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkBytes = 16384;  // bytes of K (and of V) per chunk

using pdtx::from_float;
using pdtx::to_float;

// ---------------------------------------------------------------------------
// fp32, bf16 at head_dim 256, G > 16: one block per (request, KV head)
// ---------------------------------------------------------------------------

template <typename T, int D>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);       // elements per load
  static constexpr int kRowVecs = D / kVec;         // loads per K/V row
  static constexpr int kChunk = kChunkBytes / (D * sizeof(T));  // tokens
  static constexpr int kLoads = kChunk * kRowVecs / kThreads;  // per thread
  static constexpr int kLd = D + kVec;              // padded row, 16B aligned
  static_assert(kChunk * kRowVecs % kThreads == 0, "chunk must split evenly");
};

// Four consecutive elements of a shared row as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Issue this thread's 16-byte loads of K and V for one chunk of tokens;
// tokens at or past n_tok load zeros (their scores are masked, and a zero
// V row keeps 0 * V finite).
template <typename T, int D>
__device__ __forceinline__ void load_chunk(
    uint4 (&kr)[Tile<T, D>::kLoads], uint4 (&vr)[Tile<T, D>::kLoads],
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int32_t* __restrict__ table, int chunk, int n_tok, int page_size,
    int Hkv, int kvh) {
  using L = Tile<T, D>;
#pragma unroll
  for (int j = 0; j < L::kLoads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / L::kRowVecs;
    const int c = i - t * L::kRowVecs;
    const int tok = chunk * L::kChunk + t;
    if (tok < n_tok) {
      const int page = table[tok / page_size];
      const size_t off =
          (((size_t)page * page_size + tok % page_size) * Hkv + kvh) * D +
          c * L::kVec;
      kr[j] = *reinterpret_cast<const uint4*>(k_pages + off);
      vr[j] = *reinterpret_cast<const uint4*>(v_pages + off);
    } else {
      kr[j] = make_uint4(0u, 0u, 0u, 0u);
      vr[j] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The chunk's rows go to shared memory as stored (16-byte writes).
template <typename T, int D>
__device__ __forceinline__ void store_chunk(
    const uint4 (&kr)[Tile<T, D>::kLoads],
    const uint4 (&vr)[Tile<T, D>::kLoads], T* k_s, T* v_s) {
  using L = Tile<T, D>;
#pragma unroll
  for (int j = 0; j < L::kLoads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / L::kRowVecs;
    const int c = i - t * L::kRowVecs;
    *reinterpret_cast<uint4*>(k_s + t * L::kLd + c * L::kVec) = kr[j];
    *reinterpret_cast<uint4*>(v_s + t * L::kLd + c * L::kVec) = vr[j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,                 // [B, H, D]
    const T* __restrict__ k_pages,           // [P, page_size, Hkv, D]
    const T* __restrict__ v_pages,           // [P, page_size, Hkv, D]
    const int32_t* __restrict__ page_table,  // [B, max_pages]
    const int32_t* __restrict__ positions,   // [B]
    T* __restrict__ out,                     // [B, H, D]
    int H, int Hkv, int page_size, int max_pages, float sm_scale) {
  using L = Tile<T, D>;
  constexpr int C = L::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  T* k_s = reinterpret_cast<T*>(smem_raw);      // [C, kLd] as stored
  T* v_s = k_s + C * L::kLd;                    // [C, kLd] as stored
  float* q_s = reinterpret_cast<float*>(v_s + C * L::kLd);  // [G, D]
  float* acc_s = q_s + G * D;       // [G, D]
  float* p_s = acc_s + G * D;       // [G, C] scores, then probabilities
  float* m_s = p_s + G * C;         // [G] running max
  float* l_s = m_s + G;             // [G] running sum
  float* c_s = l_s + G;             // [G] this chunk's correction

  const int pos = positions[b];
  const int n_tok = min(pos + 1, max_pages * page_size);
  const int n_chunks = (n_tok + C - 1) / C;
  const int32_t* table = page_table + (size_t)b * max_pages;
  const T* q_b = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_float(q_b[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  uint4 kr[L::kLoads], vr[L::kLoads];
  if (n_chunks > 0)
    load_chunk<T, D>(kr, vr, k_pages, v_pages, table, 0, n_tok, page_size,
                     Hkv, kvh);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    __syncthreads();  // the previous chunk is consumed; q_s/m_s are set
    store_chunk<T, D>(kr, vr, k_s, v_s);
    __syncthreads();
    if (chunk + 1 < n_chunks)  // in flight while this chunk is computed
      load_chunk<T, D>(kr, vr, k_pages, v_pages, table, chunk + 1, n_tok,
                       page_size, Hkv, kvh);

    // Scores: one thread per (query head, token), four columns per read.
    for (int i = tid; i < G * C; i += kThreads) {
      const int g = i / C;
      const int t = i - g * C;
      const float* qg = q_s + g * D;
      const T* kt = k_s + t * L::kLd;
      float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 a = load4(qg + d);
        const float4 k4 = load4(kt + d);
        dot.x += a.x * k4.x;
        dot.y += a.y * k4.y;
        dot.z += a.z * k4.z;
        dot.w += a.w * k4.w;
      }
      p_s[i] = (chunk * C + t < n_tok)
                   ? ((dot.x + dot.y) + (dot.z + dot.w)) * sm_scale
                   : kNegInf;
    }
    __syncthreads();

    // Online softmax: one warp per query head.
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * C;
      float mx = m_s[g];
      for (int t = lane; t < C; t += 32) mx = fmaxf(mx, row[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int t = lane; t < C; t += 32) {
        const float e = expf(row[t] - mx);
        row[t] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_s[g] - mx);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = mx;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // Accumulator: one thread per (query head, four output columns).
    for (int i = tid; i < G * D / 4; i += kThreads) {
      const int g = i / (D / 4);
      const int d = (i - g * (D / 4)) * 4;
      const float* pg = p_s + g * C;
      const float corr = c_s[g];
      float4 a = *reinterpret_cast<float4*>(acc_s + g * D + d);
      a.x *= corr;
      a.y *= corr;
      a.z *= corr;
      a.w *= corr;
#pragma unroll 8
      for (int t = 0; t < C; ++t) {
        const float p = pg[t];
        const float4 v4 = load4(v_s + t * L::kLd + d);
        a.x += p * v4.x;
        a.y += p * v4.y;
        a.z += p * v4.z;
        a.w += p * v4.w;
      }
      *reinterpret_cast<float4*>(acc_s + g * D + d) = a;
    }
  }
  __syncthreads();
  T* out_b = out + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    out_b[i] = from_float<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* positions, void* out, int B,
           int H, int Hkv, int page_size, int max_pages, float sm_scale,
           cudaStream_t stream) {
  using L = Tile<T, D>;
  const int G = H / Hkv;
  const size_t smem =
      sizeof(T) * 2 * (size_t)L::kChunk * L::kLd +
      sizeof(float) * (2 * (size_t)G * D + (size_t)G * L::kChunk +
                       3 * (size_t)G);
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, Hkv);
  paged_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(positions), static_cast<T*>(out), H, Hkv,
      page_size, max_pages, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k_pages, const void* v_pages,
             const void* page_table, const void* positions, void* out, int B,
             int H, int Hkv, int D, int page_size, int max_pages,
             float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, page_table, positions, out, B,
                           H, Hkv, page_size, max_pages, sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, page_table, positions, out,
                            B, H, Hkv, page_size, max_pages, sm_scale, stream);
    case 256:
      return launch<T, 256>(q, k_pages, v_pages, page_table, positions, out,
                            B, H, Hkv, page_size, max_pages, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 at head_dim 64 and 128, G <= 16: split-KV on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTile = 16;  // tokens a warp step: the products' m and k
constexpr int kMaxStages = 2;
constexpr int kMaxSplitPages = kThreads;  // one page id a thread
constexpr int kMergeBatch = 8;            // splits merged a batch
// The fp32 words a split's partial state takes beside acc [G, D]: m [16],
// then l [16] (so every slot starts 16-byte aligned).
constexpr int kStateWords = 32;
constexpr float kLog2e = 1.4426950408889634f;

struct SplitArgs {
  const __nv_bfloat16* q;        // [B, H, D]
  const int32_t* page_table;     // [B, max_pages]
  const int32_t* positions;      // [B]
  __nv_bfloat16* out;            // [B, H, D]
  float* partial;  // [B, Hkv, n_splits, G * D + kStateWords]
  unsigned* counters;  // [B, Hkv], 0 between calls
  int H, Hkv, page_shift, max_pages, pages_per_split, n_splits;
  float scale_log2;  // sm_scale * log2(e): scores in the ex2 domain
};

// A tile of K (or V) in shared memory: 16 token rows of each 64-column half
// as TMA writes them, 128 bytes a row with the 128-byte swizzle; a stage of
// a warp's ring is a K tile and a V tile.
template <int D>
struct Split {
  static constexpr int kHalves = D / 64;
  static constexpr int kHalfBytes = kTile * 128;
  static constexpr int kTileBytes = kHalves * kHalfBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kKS = D / 16;  // k steps of S^T, m tiles of O^T
  // A warp's final acc [16, D] reuses its ring.
  static_assert(16 * D * 4 <= kStageBytes, "state fits a stage");
};

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled half.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The 16 token rows from pool row `row0` of KV head `kvh` into a stage:
// one TMA box a 64-column half of K and of V, counted on `bar`.
template <int D>
__device__ __forceinline__ void issue_tile(unsigned char* stage, uint64_t* bar,
                                           const CUtensorMap* k_map,
                                           const CUtensorMap* v_map, int row0,
                                           int kvh) {
  using S = Split<D>;
  pdtx::fence_proxy_async();  // the stage's last reads before the refill
  pdtx::mbar_arrive_expect_tx(bar, S::kStageBytes);
#pragma unroll
  for (int h = 0; h < S::kHalves; ++h) {
    pdtx::tma_load_3d(stage + h * S::kHalfBytes, k_map, bar, h * 64, kvh,
                      row0);
    pdtx::tma_load_3d(stage + S::kTileBytes + h * S::kHalfBytes, v_map, bar,
                      h * 64, kvh, row0);
  }
}

template <int D, int NH, int NS>
__global__ void __launch_bounds__(kThreads) paged_decode_mma_kernel(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const SplitArgs a) {
  using S = Split<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int page_s[kMaxSplitPages];
  __shared__ float ml_s[kWarps][2][16];  // each warp's m and l a query head
  __shared__ uint64_t bar_s[kWarps][NS];
  __shared__ int is_last;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int G = a.H / a.Hkv;
  __nv_bfloat16* out_b = a.out + ((size_t)b * a.H + (size_t)kvh * G) * D;

  // The position and the split's page ids are read together; a block whose
  // split starts past the position returns without waiting for the ids.
  const int pos = a.positions[b];
  const int p0 = split * a.pages_per_split;
  int page = 0;
  if (tid < a.pages_per_split && p0 + tid < a.max_pages)
    page = a.page_table[(size_t)b * a.max_pages + p0 + tid];
  const int n_tok = min(pos + 1, a.max_pages << a.page_shift);
  const int split_tok = a.pages_per_split << a.page_shift;
  const int n_live = n_tok > 0 ? (n_tok + split_tok - 1) / split_tok : 0;
  if (split >= n_live) {
    if (split == 0)  // no key at all: acc / max(l, 1e-30) is 0
      for (int i = tid; i < G * D; i += kThreads)
        out_b[i] = __float2bfloat16(0.f);
    return;
  }
  page_s[tid] = page;
  __syncthreads();
  const int s0 = split * split_tok;
  const int s1 = min(s0 + split_tok, n_tok);
  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps
                                      : 0;
  unsigned char* ring =
      pdtx::align_1024(smem_raw) + warp * NS * S::kStageBytes;
  uint64_t* bars = bar_s[warp];
  auto tile_t0 = [&](int i) { return s0 + (warp + kWarps * i) * kTile; };
  // Lane 0 of each warp keeps its ring full: the page id of a tile's
  // tokens (a tile never crosses a page: pages are multiples of 16 tokens)
  // gives the pool row of its first token.
  auto issue = [&](int i) {
    const int t0 = tile_t0(i);
    const int row0 = (page_s[(t0 >> a.page_shift) - p0] << a.page_shift) +
                     (t0 & ((1 << a.page_shift) - 1));
    issue_tile<D>(ring + i % NS * S::kStageBytes, &bars[i % NS], &k_map,
                  &v_map, row0, kvh);
  };
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) pdtx::mbar_init(&bars[i], 1);
    pdtx::mbar_fence_init();
    for (int i = 0; i < NS - 1 && i < my_tiles; ++i) issue(i);
  }
  __syncwarp();

  // Q^T as the B fragments of the score products, query heads on the N
  // columns (NH tiles of 8); heads past G are zero.
  const __nv_bfloat16* q_h = a.q + ((size_t)b * a.H + (size_t)kvh * G) * D;
  uint32_t qf[S::kKS][NH][2];
#pragma unroll
  for (int kk = 0; kk < S::kKS; ++kk)
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      const int g = nh * 8 + gid;
      const __nv_bfloat16* row = q_h + g * D + kk * 16 + 2 * tig;
      qf[kk][nh][0] = g < G ? pdtx::ld32(row) : 0u;
      qf[kk][nh][1] = g < G ? pdtx::ld32(row + 8) : 0u;
    }

  // This warp's online softmax over its tiles. The thread holds query
  // heads nh * 8 + 2 tig + e (e < 2) and, of O^T, rows d = mt * 16 + gid
  // (+ 8).
  float acc[S::kKS][NH][4];
#pragma unroll
  for (int mt = 0; mt < S::kKS; ++mt)
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
      acc[mt][nh][0] = acc[mt][nh][1] = acc[mt][nh][2] = acc[mt][nh][3] = 0.f;
  float m[NH][2], l[NH][2];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) {
    m[nh][0] = m[nh][1] = kNegInf;
    l[nh][0] = l[nh][1] = 0.f;
  }
  for (int i = 0; i < my_tiles; ++i) {
    if (lane == 0 && i + NS - 1 < my_tiles) issue(i + NS - 1);
    pdtx::mbar_wait(&bars[i % NS], (i / NS) & 1);
    const unsigned char* k_s = ring + i % NS * S::kStageBytes;
    unsigned char* v_s = ring + i % NS * S::kStageBytes + S::kTileBytes;
    const int t0 = tile_t0(i);
    // Rows past the request's last token hold whatever the pool holds: V's
    // are zeroed (a masked probability times a NaN would still be NaN).
    if (s1 - t0 < kTile) {
      const int valid = s1 - t0;
      for (int v = lane; v < (kTile - valid) * S::kHalves * 8; v += 32) {
        const int row = valid + v / (S::kHalves * 8);
        const int c = v % (S::kHalves * 8);
        *reinterpret_cast<uint4*>(v_s + (c >> 3) * S::kHalfBytes + row * 128 +
                                  (c & 7) * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncwarp();
    }

    // S^T = K Q^T (16 tokens x 8 NH heads), K as the A operand, in two
    // independent chains (even and odd k steps).
    float sc[NH][4] = {}, sc_odd[NH][4] = {};
#pragma unroll
    for (int kk = 0; kk < S::kKS; ++kk) {
      uint32_t ka[4];
      pdtx::ldmatrix_x4(
          ka, reinterpret_cast<const __nv_bfloat16*>(
                  k_s + (kk >> 2) * S::kHalfBytes +
                  swz(lane & 15, ((kk & 3) << 1) + (lane >> 4))));
      float(&c)[NH][4] = kk % 2 ? sc_odd : sc;
#pragma unroll
      for (int nh = 0; nh < NH; ++nh)
        pdtx::mma_bf16(c[nh], ka[0], ka[1], ka[2], ka[3], qf[kk][nh][0],
                       qf[kk][nh][1]);
    }
    // sc[nh][j]: token gid (j < 2) or gid + 8, head nh * 8 + 2 tig + j % 2.
    const bool ok_lo = t0 + gid < s1, ok_hi = t0 + gid + 8 < s1;
    float corr[NH][2];
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo =
            ok_lo ? (sc[nh][e] + sc_odd[nh][e]) * a.scale_log2 : kNegInf;
        const float hi =
            ok_hi ? (sc[nh][2 + e] + sc_odd[nh][2 + e]) * a.scale_log2
                  : kNegInf;
        float mx = fmaxf(lo, hi);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[nh][e], mx);
        corr[nh][e] = pdtx::exp2_approx(m[nh][e] - m_new);
        m[nh][e] = m_new;
        sc[nh][e] = pdtx::exp2_approx(lo - m_new);
        sc[nh][2 + e] = pdtx::exp2_approx(hi - m_new);
        l[nh][e] = l[nh][e] * corr[nh][e] + sc[nh][e] + sc[nh][2 + e];
      }
    // P^T rounded to bf16 and transposed in registers: the B fragments
    // (tokens on k, heads on n) of O^T += V^T P^T.
    uint32_t pb[NH][2];
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      pb[nh][0] = pdtx::movmatrix_trans(pdtx::pack_bf16(sc[nh][0], sc[nh][1]));
      pb[nh][1] = pdtx::movmatrix_trans(pdtx::pack_bf16(sc[nh][2], sc[nh][3]));
    }
#pragma unroll
    for (int mt = 0; mt < S::kKS; ++mt) {
      uint32_t va[4];
      pdtx::ldmatrix_x4_trans(
          va, reinterpret_cast<const __nv_bfloat16*>(
                  v_s + (mt >> 2) * S::kHalfBytes +
                  swz(((lane >> 4) << 3) + (lane & 7),
                      ((mt & 3) << 1) + ((lane >> 3) & 1))));
#pragma unroll
      for (int nh = 0; nh < NH; ++nh) {
        float(&c)[4] = acc[mt][nh];
        c[0] *= corr[nh][0];
        c[1] *= corr[nh][1];
        c[2] *= corr[nh][0];
        c[3] *= corr[nh][1];
        pdtx::mma_bf16(c, va[0], va[1], va[2], va[3], pb[nh][0], pb[nh][1]);
      }
    }
    __syncwarp();  // the stage is read before a later tile refills it
  }

  // The warp's state into its own ring (l summed over the 8 token lanes).
  float* st = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& le = l[nh][e];
      le += __shfl_xor_sync(0xffffffffu, le, 4);
      le += __shfl_xor_sync(0xffffffffu, le, 8);
      le += __shfl_xor_sync(0xffffffffu, le, 16);
      const int g = nh * 8 + 2 * tig + e;
      if (g < G) {
#pragma unroll
        for (int mt = 0; mt < S::kKS; ++mt) {
          st[g * D + mt * 16 + gid] = acc[mt][nh][e];
          st[g * D + mt * 16 + gid + 8] = acc[mt][nh][2 + e];
        }
        if (gid == 0) {
          ml_s[warp][0][g] = m[nh][e];
          ml_s[warp][1][g] = le;
        }
      }
    }
  __syncthreads();

  // The four warps' states merged in warp order; one live split writes the
  // output, more write this split's partial.
  const int stride = G * D + kStateWords;
  float* slots =
      a.partial + ((size_t)b * a.Hkv + kvh) * a.n_splits * (size_t)stride;
  for (int i = tid; i < G * D / 4; i += kThreads) {
    const int g = i / (D / 4);
    const int d = (i - g * (D / 4)) * 4;
    const float* w0 = reinterpret_cast<const float*>(
        pdtx::align_1024(smem_raw));
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, ml_s[w][0][g]);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float lw = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* sw = w0 + w * NS * S::kStageBytes / 4;
      const float c = pdtx::exp2_approx(ml_s[w][0][g] - mw);
      const float4 x = *reinterpret_cast<const float4*>(sw + g * D + d);
      o.x += c * x.x;
      o.y += c * x.y;
      o.z += c * x.z;
      o.w += c * x.w;
      lw += c * ml_s[w][1][g];
    }
    if (n_live == 1) {
      const float inv = 1.f / fmaxf(lw, 1e-30f);
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(out_b + g * D + d);
      dst[0] = __floats2bfloat162_rn(o.x * inv, o.y * inv);
      dst[1] = __floats2bfloat162_rn(o.z * inv, o.w * inv);
    } else {
      float* slot = slots + (size_t)split * stride;
      *reinterpret_cast<float4*>(slot + g * D + d) = o;
      if (d == 0) {
        slot[G * D + g] = mw;
        slot[G * D + 16 + g] = lw;
      }
    }
  }
  if (n_live == 1) return;

  // One thread publishes the block's partial and counts the arrival with
  // one acquire-release increment (the barrier orders the other threads'
  // writes before it); the increment wraps the counter of the last block of
  // the (request, KV head) back to 0 for the next call.
  __syncthreads();
  if (tid == 0)
    is_last = pdtx::arrive_last(a.counters + (size_t)b * a.Hkv + kvh, n_live);
  __syncthreads();
  if (!is_last) return;

  // The merge, in split order, kMergeBatch splits' loads in flight at once
  // (an online merge across batches).
  const int n_merge = n_live;
  for (int i = tid; i < G * D / 4; i += kThreads) {
    const int g = i / (D / 4);
    const int d = (i - g * (D / 4)) * 4;
    const float* acc_s = slots + g * D + d;
    const float* m_s = slots + G * D + g;
    float ms = kNegInf, ls = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_merge; s0 += kMergeBatch) {
      float mb[kMergeBatch], lb[kMergeBatch];
      float4 xb[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int off = (s0 + j) * stride;
        const bool in = s0 + j < n_merge;
        mb[j] = in ? __ldcg(m_s + off) : kNegInf;
        lb[j] = in ? __ldcg(m_s + 16 + off) : 0.f;
        xb[j] = in ? __ldcg(reinterpret_cast<const float4*>(acc_s + off))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mx = ms;
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) mx = fmaxf(mx, mb[j]);
      const float c0 = pdtx::exp2_approx(ms - mx);
      o.x *= c0;
      o.y *= c0;
      o.z *= c0;
      o.w *= c0;
      ls *= c0;
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const float c = pdtx::exp2_approx(mb[j] - mx);
        o.x += c * xb[j].x;
        o.y += c * xb[j].y;
        o.z += c * xb[j].z;
        o.w += c * xb[j].w;
        ls += c * lb[j];
      }
      ms = mx;
    }
    const float inv = 1.f / fmaxf(ls, 1e-30f);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out_b + g * D + d);
    dst[0] = __floats2bfloat162_rn(o.x * inv, o.y * inv);
    dst[1] = __floats2bfloat162_rn(o.z * inv, o.w * inv);
  }
}

template <int D, int NH, int NS>
int launch_split(const CUtensorMap& k_map, const CUtensorMap& v_map,
                 const SplitArgs& a, int B, cudaStream_t stream) {
  const size_t smem = 1024 + kWarps * NS * (size_t)Split<D>::kStageBytes;
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_mma_kernel<D, NH, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.n_splits, a.Hkv, B);
  paged_decode_mma_kernel<D, NH, NS>
      <<<grid, kThreads, smem, stream>>>(k_map, v_map, a);
  return (int)cudaGetLastError();
}

// The heads' N tiles (one up to G = 8, two up to 16) and the ring's depth
// (two stages, or one where no warp takes two tiles).
template <int D, int NH>
int launch_split_h(const CUtensorMap& k_map, const CUtensorMap& v_map,
                   const SplitArgs& a, int B, cudaStream_t stream) {
  const int tiles = ((a.pages_per_split << a.page_shift) + kTile - 1) / kTile;
  return tiles > kWarps
             ? launch_split<D, NH, kMaxStages>(k_map, v_map, a, B, stream)
             : launch_split<D, NH, 1>(k_map, v_map, a, B, stream);
}

// A 3-D map over a K or V pool [P, page_size, Hkv, D] as D columns, Hkv
// heads and P * page_size token rows; a box is 64 columns of one head by
// 16 token rows, 128-byte swizzled.
int encode_pool_map(CUtensorMap* map, const void* pool, int num_pages,
                    int page_size, int Hkv, int D) {
  const pdtx::TensorMapEncodeFn encode = pdtx::tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t size[3] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                              (cuuint64_t)num_pages * page_size};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2};
  const cuuint32_t box[3] = {64, 1, kTile};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(pool), size,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_split_d(const void* k_pages, const void* v_pages, int num_pages,
                   int page_size, const SplitArgs& a, int B,
                   cudaStream_t stream) {
  CUtensorMap k_map, v_map;
  int err = encode_pool_map(&k_map, k_pages, num_pages, page_size, a.Hkv, D);
  if (!err)
    err = encode_pool_map(&v_map, v_pages, num_pages, page_size, a.Hkv, D);
  if (err) return err;
  return a.H / a.Hkv <= 8
             ? launch_split_h<D, 1>(k_map, v_map, a, B, stream)
             : launch_split_h<D, 2>(k_map, v_map, a, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128, 256}; the pools hold
// num_pages pages. bf16 at D 64 and 128 with G = H / Hkv <= 16 and a page
// size that is a power of two and a multiple of 16 runs the split kernel:
// pages_per_split (at most 128) and n_splits from the wrapper's planner
// (n_splits * pages_per_split >= max_pages), workspace fp32 [B, Hkv,
// n_splits, G * D + 32], counters int32 [B, Hkv] zero on entry (left
// zero). The other routes read neither.
// Returns the cudaError_t of the launch.
extern "C" int pdtx_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* positions, void* out,
                                 void* workspace, void* counters, int B,
                                 int H, int Hkv, int D, int num_pages,
                                 int page_size, int max_pages,
                                 int pages_per_split, int n_splits,
                                 float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int page_shift = 0;
  while ((1 << page_shift) < page_size) ++page_shift;
  if (dtype == 1 && (D == 64 || D == 128) && H / Hkv <= 16 &&
      page_size == 1 << page_shift && page_size % kTile == 0) {
    if (pages_per_split < 1 || pages_per_split > kMaxSplitPages ||
        n_splits < 1 || (long long)pages_per_split * n_splits < max_pages)
      return (int)cudaErrorInvalidValue;
    const SplitArgs a{static_cast<const __nv_bfloat16*>(q),
                      static_cast<const int32_t*>(page_table),
                      static_cast<const int32_t*>(positions),
                      static_cast<__nv_bfloat16*>(out),
                      static_cast<float*>(workspace),
                      static_cast<unsigned*>(counters),
                      H, Hkv, page_shift, max_pages, pages_per_split,
                      n_splits, sm_scale * kLog2e};
    return D == 64 ? launch_split_d<64>(k_pages, v_pages, num_pages,
                                        page_size, a, B, s)
                   : launch_split_d<128>(k_pages, v_pages, num_pages,
                                         page_size, a, B, s);
  }
  if (dtype == 0)
    return launch_d<float>(q, k_pages, v_pages, page_table, positions, out, B,
                           H, Hkv, D, page_size, max_pages, sm_scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k_pages, v_pages, page_table, positions,
                                   out, B, H, Hkv, D, page_size, max_pages,
                                   sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
