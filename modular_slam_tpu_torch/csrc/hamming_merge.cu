// Merge of the Hamming 2-NN split triples and the Lowe ratio test,
// hand-written for Hopper (sm_90a).
//
// Replaces the XLA epilogue of the Pallas matcher,
// modular_slam_tpu/ops/match_pallas.py:182-196 (per-tile top-2 -> global
// top-2, then the ratio test), which follows the Pallas kernel
// _tile_kernel (:61) that csrc/hamming_2nn.cu replaces.  It merges the S
// triples (best, first index, second) of each (batch, query) by the
// first-index tie rule and writes `Matches` directly:
//   valid = query_valid & best < 1e9 & best <= max_hamming
//           & best < lowe_ratio * second,
// lm_slot = the first index of the best, distance = best.
//
// What bounds it on this card: latency.  At Nq = 512 and S = 64 it reads
// 393 KB of triples and writes 4.6 KB, well under a microsecond of
// memory time, so the design shortens the chain of dependent loads: one
// warp per query, each lane merging the splits lane, lane + 32, ... and
// the lanes then merging by five __shfl_xor_sync (the merge keeps the
// first index on ties whatever the order, so the tree gives what the
// split order gives).  It replaces about 15 PyTorch ops (argmin, gathers,
// masks, the ratio test) with one launch on a path limited by dispatch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 1e9f;   // distance of an invalid landmark

// merge triple 2 into triple 1 (disjoint column sets; idx < 0: empty)
__device__ __forceinline__ void merge(float& b1, int& i1, float& s1,
                                      float b2, int i2, float s2) {
  const bool take2 = (b2 < b1) || (b2 == b1 && i2 >= 0 && (i1 < 0 || i2 < i1));
  if (take2) {
    s1 = fminf(s2, b1);
    b1 = b2;
    i1 = i2;
  } else {
    s1 = fminf(s1, b2);
  }
}

__global__ void __launch_bounds__(kThreads)
hamming_merge_kernel(const float* __restrict__ best_p,
                     const int* __restrict__ idx_p,
                     const float* __restrict__ second_p,
                     const uint8_t* __restrict__ q_valid,
                     int* __restrict__ lm_slot, float* __restrict__ distance,
                     uint8_t* __restrict__ valid, int B, int S, int Nq,
                     long long qv_bs, float max_hamming, float lowe_ratio) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) / 32;   // one warp per (batch, query)
  const int lane = threadIdx.x & 31;
  if (i >= static_cast<long long>(B) * Nq) return;   // whole warps leave
  const int b = static_cast<int>(i / Nq);
  const int n = static_cast<int>(i - static_cast<long long>(b) * Nq);
  float best = INFINITY;
  float second = kBig;
  int idx = -1;
  const size_t base = static_cast<size_t>(b) * S * Nq + n;
  for (int s = lane; s < S; s += 32) {
    const size_t o = base + static_cast<size_t>(s) * Nq;
    merge(best, idx, second, best_p[o], idx_p[o], second_p[o]);
  }
#pragma unroll
  for (int m = 1; m < 32; m <<= 1)
    merge(best, idx, second, __shfl_xor_sync(0xffffffffu, best, m),
          __shfl_xor_sync(0xffffffffu, idx, m),
          __shfl_xor_sync(0xffffffffu, second, m));
  if (lane == 0) {
    const bool ok = q_valid[b * qv_bs + n] && best < kBig &&
                    best <= max_hamming && best < lowe_ratio * second;
    lm_slot[i] = idx;
    distance[i] = best;
    valid[i] = ok ? 1 : 0;
  }
}

}  // namespace

// triples [B, S, Nq]; q_valid [B?, Nq] uint8 (batch stride qv_bs, 0 when
// shared); outputs [B, Nq]: lm_slot int32, distance float32, valid bool.
extern "C" int mslam_hamming_merge(const void* best, const void* idx,
                                   const void* second, const void* q_valid,
                                   void* lm_slot, void* distance, void* valid,
                                   int B, int S, int Nq, long long qv_bs,
                                   float max_hamming, float lowe_ratio,
                                   void* stream) {
  const long long warps = static_cast<long long>(B) * Nq;
  const long long per_block = kThreads / 32;
  const unsigned blocks =
      static_cast<unsigned>((warps + per_block - 1) / per_block);
  hamming_merge_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(best), static_cast<const int*>(idx),
      static_cast<const float*>(second),
      static_cast<const uint8_t*>(q_valid), static_cast<int*>(lm_slot),
      static_cast<float*>(distance), static_cast<uint8_t*>(valid), B, S, Nq,
      qv_bs, max_hamming, lowe_ratio);
  return static_cast<int>(cudaGetLastError());
}
