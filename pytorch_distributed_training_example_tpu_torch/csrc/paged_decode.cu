// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`, launched by
// `_paged_decode_pallas` in pytorch_distributed_training_example_tpu/ops/
// flash_attention.py: one query token per request against K/V pages reached
// through a page table, GQA grouped per KV head, keys masked to
// `k_pos <= pos`, pages past `pos` skipped, online softmax across the cache.
//
// What bounds it on this card: memory. A decode step reads every live K/V
// row once and does ~4 flops per byte read, far below the H100's ~295
// flop/byte balance point, so the least time is the live K/V bytes over
// 3.35 TB/s.
//
// What the design does about it:
// - One block per (request, KV head) serves the G query heads that share
//   that KV head, so each K/V row is read from device memory once per step,
//   never once per query head.
// - The block walks the cache in chunks of 16 KB of K (and of V): each
//   thread issues its eight 16-byte loads of a chunk at once, looking up
//   each token's page in the page table itself (this replaces the TPU
//   kernel's scalar prefetch), and the loads of chunk c+1 are in flight
//   while chunk c is computed. Tokens past `pos` are never read.
// - Staged rows stay in their stored type in shared memory, with a padded
//   stride; the thread-per-score and thread-per-four-outputs loops read
//   four columns at a time and convert to fp32 in registers, which keeps
//   shared-memory traffic (the limit of one block on an SM) low. The
//   online-softmax state (max, sum, accumulator) stays in shared memory in
//   fp32.
// All arithmetic is fp32 (bf16 or fp32 storage), matching the gather-based
// plain version. With one block per (request, KV head) a small batch fills
// few of the 132 SMs; splitting the cache across blocks (split-KV), TMA and
// tensor-core products are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as in the JAX kernels
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkBytes = 16384;  // bytes of K (and of V) per chunk

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128, 256}. Returns the
// cudaError_t of the launch.
extern "C" int pdtx_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* positions, void* out, int B,
                                 int H, int Hkv, int D, int page_size,
                                 int max_pages, float sm_scale, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k_pages, v_pages, page_table, positions, out, B,
                           H, Hkv, D, page_size, max_pages, sm_scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k_pages, v_pages, page_table, positions,
                                   out, B, H, Hkv, D, page_size, max_pages,
                                   sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
