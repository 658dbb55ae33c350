// Hamming 2-NN over landmark chunks, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel modular_slam_tpu/ops/match_pallas.py
// (_tile_kernel, :61) and keeps its contract: ±1 int8 descriptor rows in
// (256 per row), and per landmark chunk g and query n the triple
//   best[g, n]   = min_l d(n, l)                  over the chunk's columns,
//   idx[g, n]    = first column index reaching it (global landmark index),
//   second[g, n] = min over the chunk with only that column masked to 1e9,
// where d = (256 - q.t) / 2 is the Hamming distance and an invalid
// landmark has d = 1e9.  Equal bests therefore give second == best, and
// the 0.7 ratio test rejects them.  The [G, Nq] triples are merged by the
// plain PyTorch epilogue in ops/match.py, as XLA merged them in JAX.
//
// What bounds it on this card: at Nq = 512 and L = 16384 the landmark
// descriptors (4 MB of int8) are the only large operand, and a TPU-style
// sequential walk over L would leave most of the 132 SMs idle.  Design:
// L is cut into chunks of 512 landmarks that blocks take in any order
// (grid y), queries into groups of 64 (grid x), batch on grid z — 256
// blocks at the default size.  A block packs its chunk to bits in shared
// memory (8 words of 32 bits per row; bit i is element i > 0), so one
// distance is 8 XOR + popcount instead of 256 multiply-adds: for ±1 rows
// popcount(a ^ b) equals (256 - a.b) / 2 exactly.  Each query is served
// by 4 threads that walk interleaved columns in increasing order, keeping
// (best, idx, second) in registers with the first-index tie rule; the 4
// partial triples are then merged in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBits = 256;
constexpr int kWords = kBits / 32;
constexpr int kQB = 64;       // queries per block
constexpr int kSplit = 4;     // threads per query
constexpr int kThreads = kQB * kSplit;
constexpr int kChunk = 512;   // landmarks per block (one output tile);
                              // ops/match.py HAMMING_CHUNK must equal it
constexpr float kBig = 1e9f;  // distance of an invalid landmark

// 32 int8 elements (16-byte aligned) -> 32 bits, bit j = (element j > 0)
__device__ __forceinline__ uint32_t pack_word(const int8_t* p) {
  const int4* v = reinterpret_cast<const int4*>(p);
  const int4 a = v[0];
  const int4 b = v[1];
  const int vals[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t e = static_cast<int8_t>((vals[k] >> (8 * j)) & 0xff);
      w |= static_cast<uint32_t>(e > 0) << (4 * k + j);
    }
  }
  return w;
}

// Merge partial triple 2 into triple 1 (both over disjoint column sets).
// idx < 0 marks an empty set (best = +inf).
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
hamming_2nn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                   const uint8_t* __restrict__ t_valid,
                   float* __restrict__ best_out, int* __restrict__ idx_out,
                   float* __restrict__ second_out, int Nq, int L, int G,
                   long long q_bs, long long t_bs, long long tv_bs) {
  __shared__ uint32_t t_bits[kChunk][kWords + 1];  // +1: no bank conflicts
  __shared__ uint8_t t_ok[kChunk];
  __shared__ uint32_t q_bits[kQB][kWords + 1];
  __shared__ float p_best[kSplit][kQB];
  __shared__ float p_second[kSplit][kQB];
  __shared__ int p_idx[kSplit][kQB];

  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int l0 = g * kChunk;
  const int nl = min(kChunk, L - l0);
  const int8_t* qb = q + b * q_bs;
  const int8_t* tb = t + b * t_bs;
  const uint8_t* vb = t_valid + b * tv_bs;

  for (int i = threadIdx.x; i < nl * kWords; i += kThreads) {
    const int r = i / kWords;
    const int w = i - r * kWords;
    t_bits[r][w] = pack_word(tb + static_cast<size_t>(l0 + r) * kBits + w * 32);
  }
  for (int i = threadIdx.x; i < nl; i += kThreads) t_ok[i] = vb[l0 + i];
  for (int i = threadIdx.x; i < kQB * kWords; i += kThreads) {
    const int r = i / kWords;
    const int w = i - r * kWords;
    const int qi = q0 + r;
    q_bits[r][w] =
        qi < Nq ? pack_word(qb + static_cast<size_t>(qi) * kBits + w * 32) : 0u;
  }
  __syncthreads();

  const int ql = threadIdx.x % kQB;
  const int part = threadIdx.x / kQB;
  uint32_t qw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) qw[w] = q_bits[ql][w];

  float best = INFINITY;
  float second = kBig;
  int idx = -1;
  for (int r = part; r < nl; r += kSplit) {
    int pc = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) pc += __popc(qw[w] ^ t_bits[r][w]);
    const float d = t_ok[r] ? static_cast<float>(pc) : kBig;
    if (d < best) {
      second = fminf(second, best);
      best = d;
      idx = l0 + r;
    } else if (d < second) {
      second = d;
    }
  }
  p_best[part][ql] = best;
  p_second[part][ql] = second;
  p_idx[part][ql] = idx;
  __syncthreads();

  if (part == 0) {
#pragma unroll
    for (int p = 1; p < kSplit; ++p)
      merge(best, idx, second, p_best[p][ql], p_idx[p][ql], p_second[p][ql]);
    const int qi = q0 + ql;
    if (qi < Nq) {
      const size_t o = (static_cast<size_t>(b) * G + g) * Nq + qi;
      best_out[o] = best;
      idx_out[o] = idx;
      second_out[o] = second;
    }
  }
}

}  // namespace

extern "C" int mslam_hamming_2nn_tiles(const void* q, const void* t,
                                       const void* t_valid, void* best,
                                       void* idx, void* second, int B, int Nq,
                                       int L, int G, long long q_bs,
                                       long long t_bs, long long tv_bs,
                                       void* stream) {
  const dim3 grid((Nq + kQB - 1) / kQB, G, B);
  hamming_2nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(t),
      static_cast<const uint8_t*>(t_valid), static_cast<float*>(best),
      static_cast<int*>(idx), static_cast<float*>(second), Nq, L, G, q_bs,
      t_bs, tv_bs);
  return static_cast<int>(cudaGetLastError());
}
