// Fused MoE router for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_router_kernel`, launched by
// `_fused_router_call` in pytorch_distributed_training_example_tpu/ops/
// fused_router.py: one pass over the fp32 [T, E] router logits that emits
// the renormalised top-k gates [T, k], the chosen experts [T, k] (int32, in
// lax.top_k order: ties go to the lower expert index), the logsumexp of each
// row [T] and the mean probability of each expert over all T rows [E].
//
// What bounds it on this card: neither rate. At the llama_moe shape
// (T = 8192, E = 8, k = 2) it moves ~0.43 MB (0.13 us at 3.35 TB/s) and does
// ~0.3 M operations, so a call costs its launch and the chain of dependent
// trips to memory after it.
//
// What the design does about it: one launch, and a short chain after it.
// - A row is spread over G lanes (G = E's template bound, at most 32), so
//   that the row's expf and divisions run side by side, not one after
//   another in one thread: lane j of a row's group holds expert j (and j
//   + 32 where E > 32). Blocks of 256 threads take 256 / G rows (32 rows
//   at E = 8: 256 blocks at T = 8192, two on each SM at once). Each lane
//   reads its own logit, so a warp reads its rows' contiguous logits in
//   one coalesced 128-byte access.
// - The arithmetic is the plain version's: the row max (a shuffle tree:
//   max is exact in any order), expf (not __expf) of the difference, a sum
//   in expert order (every lane gathers the row's E terms and adds them in
//   order), one division a term (each lane its own, then the group
//   gathers the quotients); lse = m + logf(sum). The top-k is k rounds of a
//   strict greater-than scan in expert order, which keeps the lowest index
//   among equal maxima, as the TPU kernel's max-then-min-index does; the
//   gates are divided by max(sum, 1e-9). Lane j writes rank j.
// - probs_mean: each block sums its rows' probabilities per expert with a
//   fixed shuffle tree over a warp's rows, then the warps in order, into a
//   partial; after the partial, one arrival at the counter (one acq_rel
//   atom.inc that wraps it back to 0, so the wrapper's counters stay zero
//   between calls), then the outputs, whose writes the arrival does not
//   wait for. The block that arrives last sums the partials in a fixed
//   order and divides by T. One launch, no float atomics: bitwise
//   reproducible.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMergeDepth = 8;  // partials a thread loads at once

template <int kMaxE>
__global__ void __launch_bounds__(kThreads) router_kernel(
    const float* __restrict__ logits,  // [T, E]
    float* __restrict__ gates,         // [T, k]
    int* __restrict__ idx,             // [T, k]
    float* __restrict__ lse,           // [T]
    float* __restrict__ probs_mean,    // [E]
    float* __restrict__ partial,       // [gridDim.x, E]
    unsigned* __restrict__ counter,    // one, zero between calls
    int T, int E, int k) {
  constexpr int G = kMaxE < 32 ? kMaxE : 32;  // lanes a row
  constexpr int EPL = kMaxE / G;              // experts a lane
  constexpr int kRows = kThreads / G;         // rows a block
  __shared__ float warp_sums[kWarps][kMaxE];
  __shared__ float parts[kThreads];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid % G;  // the lane's place in its row's group
  const int t = blockIdx.x * kRows + tid / G;
  const bool valid = t < T;

  // The row's logits, lane j holding experts j + G i.
  float x[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int e = j + G * i;
    x[i] = valid && e < E ? __ldg(logits + (size_t)t * E + e) : -INFINITY;
  }
  float m = x[0];
#pragma unroll
  for (int i = 1; i < EPL; ++i) m = fmaxf(m, x[i]);
#pragma unroll
  for (int off = 1; off < G; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float p[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    p[i] = valid && j + G * i < E ? expf(x[i] - m) : 0.f;
  // The row's E terms, gathered by every lane of the group and summed in
  // expert order; each lane divides its own, and the group gathers the
  // probabilities again for the top-k.
  const int g0 = lane - j;  // the group's first lane
  float se = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    const float v = __shfl_sync(0xffffffffu, p[e / G], g0 + e % G);
    if (e < E) se += v;
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) p[i] = valid ? p[i] / se : 0.f;
  float pe[kMaxE];
#pragma unroll
  for (int e = 0; e < kMaxE; ++e)
    pe[e] = __shfl_sync(0xffffffffu, p[e / G], g0 + e % G);

  // k rounds of first-occurrence argmax over the experts not yet taken;
  // lane j keeps rank j (and j + G ...).
  unsigned long long taken = 0ull;
  float gsum = 0.f, g_mine[EPL];
  int i_mine[EPL];
  for (int r = 0; r < k; ++r) {
    float best = -INFINITY;
    int arg = -1;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e)
      if (e < E && !((taken >> e) & 1ull) && (arg < 0 || pe[e] > best)) {
        best = pe[e];
        arg = e;
      }
    taken |= 1ull << arg;
    gsum += best;
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      if (r == j + G * i) {
        g_mine[i] = best;
        i_mine[i] = arg;
      }
  }

  // This block's sums of the probabilities per expert (rows past T add 0):
  // a shuffle tree over the warp's rows (lanes G apart), then the warps in
  // order.
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    float v = p[i];
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane < G) warp_sums[warp][j + G * i] = v;
  }
  __syncthreads();
  if (tid < E) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][tid];
    partial[(size_t)blockIdx.x * E + tid] = s;
  }
  __syncthreads();
  if (tid == 0) is_last = pdtx::arrive_last(counter, gridDim.x);

  // The outputs, after the arrival: its release does not wait for them.
  if (valid) {
    const float denom = fmaxf(gsum, 1e-9f);
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      if (j + G * i < k) {
        gates[(size_t)t * k + j + G * i] = g_mine[i] / denom;
        idx[(size_t)t * k + j + G * i] = i_mine[i];
      }
    if (j == 0) lse[t] = m + logf(se);
  }
  __syncthreads();
  if (!is_last) return;

  // The merge: thread (part q, expert e) sums the partials of blocks q,
  // q + P, ... in block order (P = kThreads / E parts), then the parts
  // are added in order and divided by T.
  const int nb = gridDim.x, P = kThreads / E;
  const int e = tid % E, q = tid / E;
  float acc = 0.f;
  if (q < P) {
    for (int b0 = q; b0 < nb; b0 += kMergeDepth * P) {
      float v[kMergeDepth];
#pragma unroll
      for (int u = 0; u < kMergeDepth; ++u) {
        const int b = b0 + u * P;
        const bool in = b < nb;
        v[u] = in ? __ldcg(partial + (size_t)b * E + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kMergeDepth; ++u) acc += v[u];
    }
  }
  parts[tid] = acc;
  __syncthreads();
  if (tid < E) {
    float total = 0.f;
    for (int q2 = 0; q2 < P; ++q2) total += parts[q2 * E + tid];
    probs_mean[tid] = total / (float)T;
  }
}

// Rows a block for E experts.
int rows_per_block(int E) {
  return kThreads / (E <= 8 ? 8 : E <= 16 ? 16 : 32);
}

template <int kMaxE>
int launch(const float* logits, float* gates, int* idx, float* lse,
           float* probs_mean, float* partial, unsigned* counter, int T,
           int E, int k, cudaStream_t stream) {
  const int rows = rows_per_block(E);
  router_kernel<kMaxE><<<(T + rows - 1) / rows, kThreads, 0, stream>>>(
      logits, gates, idx, lse, probs_mean, partial, counter, T, E, k);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// logits fp32 [T, E] (T >= 1, 1 <= E <= 64, 1 <= k <= E); gates, idx,
// lse, probs_mean as above; partial: fp32 workspace [ceil(T / rows), E],
// rows = 32 (E <= 8), 16 (E <= 16) or 8;
// counter: one uint32, zero, left zero. Returns the cudaError_t of the
// launch.
extern "C" int pdtx_fused_router(const void* logits, void* gates, void* idx,
                                 void* lse, void* probs_mean, void* partial,
                                 void* counter, int T, int E, int k,
                                 void* stream) {
  if (T < 1 || E < 1 || E > 64 || k < 1 || k > E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(logits);
  float* g = static_cast<float*>(gates);
  int* i = static_cast<int*>(idx);
  float* ls = static_cast<float*>(lse);
  float* pm = static_cast<float*>(probs_mean);
  float* pa = static_cast<float*>(partial);
  unsigned* c = static_cast<unsigned*>(counter);
  if (E <= 8) return launch<8>(l, g, i, ls, pm, pa, c, T, E, k, s);
  if (E <= 16) return launch<16>(l, g, i, ls, pm, pa, c, T, E, k, s);
  if (E <= 32) return launch<32>(l, g, i, ls, pm, pa, c, T, E, k, s);
  return launch<64>(l, g, i, ls, pm, pa, c, T, E, k, s);
}

// An empty kernel on the router's grid for T rows of E experts: the floor
// any launch reads in a timing harness. Returns the cudaError_t of the
// launch.
extern "C" int pdtx_router_empty(int T, int E, void* stream) {
  const int rows = rows_per_block(E);
  empty_kernel<<<T > 0 ? (T + rows - 1) / rows : 1, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
