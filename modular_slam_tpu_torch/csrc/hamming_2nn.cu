// Hamming 2-NN over landmark splits on the int8 tensor cores, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel modular_slam_tpu/ops/match_pallas.py
// (_tile_kernel, :61) and computes what it computes, on the same operands:
// ±1 int8 descriptor rows (256 per row), d = (256 - q.t) / 2, an invalid
// landmark at d = 1e9.  Per landmark split s and query n it writes the
// triple
//   best[s, n]   = min_l d(n, l)                 over the split's columns,
//   idx[s, n]    = first column index reaching it (global landmark index),
//   second[s, n] = min over the split with only that column masked to 1e9
// (an empty split: +inf, -1, 1e9).  Equal bests therefore give second ==
// best, and the ratio test rejects them.  csrc/hamming_merge.cu merges the
// S triples of a query in split order and applies the ratio test.
//
// What bounds it on this card: at Nq = 512, L = 16384 the product is
// 2*512*16384*256 = 4.3 G int8 operations, 2.2 us at the tensor cores'
// 1,979 TOP/s, and the operands are 4.3 MB, 1.3 us at 3.35 TB/s; the
// top-2 epilogue over the 8.4 M distances costs about as much as the
// product.  Design:
//   - distances on the tensor cores, as on the TPU's MXU: mma.sync
//     m16n8k32 s8 x s8 -> s32 on the ±1 rows, no bit packing;
//   - a block of 4 warps owns 128 queries, 32 per warp (two m16 tiles),
//     whose A fragments (2 x 16 x 256 int8 = 64 registers a thread) are
//     loaded once; every landmark fragment a warp reads from shared memory
//     then feeds two products;
//   - the block walks its split of L in chunks of 128 landmarks through a
//     2-stage cp.async ring in shared memory (32 KB a stage);
//   - the k order inside a row is permuted, the same way for A and B (a
//     dot product does not care), so that a thread's fragments for two
//     k-steps are one 16-byte load; 16-byte chunks of odd rows are
//     swizzled (chunk ^ 4), so the 8 lanes of a 128-bit shared load hit
//     32 distinct banks;
//   - top-2 in registers on 32-bit keys dot * 65536 + (65535 - column in
//     the split): the larger key is the smaller distance and, on equal
//     distances, the first column, and no two columns share a key.  A
//     column's key is one multiply-add, key = dot * mul + base, with
//     (mul, base) staged per column: (65536, 65535 - col) for a valid
//     landmark, (0, the same with dot = kInvalidDot) for an invalid one
//     (d = 1e9), (0, INT_MIN) past the end of L.  The top-2 update is then
//     second = max(second, min(key, best)), best = max(best, key), and
//     the 4 lanes holding one row merge by two __shfl_xor_sync with the
//     same max/min rule;
//   - grid (Nq/128) x S x B, S chosen by ops/match.py so that about two
//     blocks run per SM.
// The batch dimension and operands shared by every batch element (batch
// stride 0) replace the Pallas kernel's custom_vmap.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBytes = 256;        // int8 elements per descriptor row
constexpr int kRowChunks = kBytes / 16;
constexpr int kWarps = 4;
constexpr int kQPW = 32;           // queries per warp (two m16 tiles)
constexpr int kQB = kWarps * kQPW; // queries per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 128;        // landmarks per ring stage;
                                   // ops/match.py HAMMING_CHUNK equals it
constexpr int kStages = 2;
constexpr int kSmemBytes = kStages * kChunk * (kBytes + 8);
// keys: dot * 65536 + (65535 - column in the split).  Rows hold -1, 0 or
// +1, so |dot| <= 256; an invalid landmark keys as dot = kInvalidDot, a
// column past the end of L as kEmpty.  A split spans at most 65536 columns.
constexpr int kInvalidDot = -32767;
constexpr int kKeyShift = 16;
constexpr int kMaxSplitColumns = 1 << kKeyShift;
constexpr int kInvalidFloor = kInvalidDot * kMaxSplitColumns;
constexpr int kEmpty = INT_MIN;
static_assert(kThreads == kChunk, "one thread stages each column's key");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the best and second-best keys of one query row; keys are distinct, so
// the second is the best over all columns but the best one
struct Top2 {
  int best = kEmpty;
  int second = kInvalidFloor;   // no second column: d = 1e9
};

__device__ __forceinline__ void push(Top2& s, int key) {
  s.second = max(s.second, min(key, s.best));
  s.best = max(s.best, key);
}

// merge another lane's pair over disjoint columns
__device__ __forceinline__ void merge_lane(Top2& s, int lane_mask) {
  const int b2 = __shfl_xor_sync(0xffffffffu, s.best, lane_mask);
  const int s2 = __shfl_xor_sync(0xffffffffu, s.second, lane_mask);
  s.second = max(max(s.second, s2), min(s.best, b2));
  s.best = max(s.best, b2);
}

__device__ __forceinline__ float to_distance(int key) {
  if (key == kEmpty) return INFINITY;
  const int dot = key >> kKeyShift;   // floor: the column part is >= 0
  if (dot == kInvalidDot) return 1e9f;
  return static_cast<float>(kBytes - dot) * 0.5f;
}

__global__ void __launch_bounds__(kThreads)
hamming_2nn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                   const uint8_t* __restrict__ t_valid,
                   float* __restrict__ best_out, int* __restrict__ idx_out,
                   float* __restrict__ second_out, int Nq, int L, int S,
                   int chunks_per_split, long long q_bs, long long t_bs,
                   long long tv_bs) {
  extern __shared__ uint4 smem[];
  uint4* ring = smem;                                        // [stage][row][16]
  int2* keys = reinterpret_cast<int2*>(smem + kStages * kChunk * kRowChunks);

  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int8_t* qb = q + b * q_bs;
  const int8_t* tb = t + b * t_bs;
  const uint8_t* vb = t_valid + b * tv_bs;

  const int n_chunks = (L + kChunk - 1) / kChunk;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, n_chunks);

  auto load_chunk = [&](int chunk, int stage) {
    uint4* dst = ring + stage * kChunk * kRowChunks;
    const int l0 = chunk * kChunk;
#pragma unroll
    for (int k = 0; k < kChunk * kRowChunks / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / kRowChunks;
      const int c = i % kRowChunks;
      const bool in = l0 + r < L;
      const int8_t* src =
          tb + static_cast<size_t>(in ? l0 + r : 0) * kBytes + c * 16;
      cp_async16(dst + r * kRowChunks + (c ^ ((r & 1) << 2)), src,
                 in ? 16 : 0);
    }
    const int col = l0 + threadIdx.x;
    const int rev = kMaxSplitColumns - 1 - ((chunk - c_begin) * kChunk +
                                            static_cast<int>(threadIdx.x));
    keys[stage * kChunk + threadIdx.x] =
        col >= L ? make_int2(0, kEmpty)
        : vb[col] ? make_int2(kMaxSplitColumns, rev)
                  : make_int2(0, kInvalidFloor + rev);
    cp_async_commit();
  };

  if (c_begin < c_end) load_chunk(c_begin, 0);

  // A fragments of this warp's 32 queries.  A thread's elements of
  // k-step ks sit at bytes j*64 + tig*16 + (ks & 1)*8 + half*4 + (0..3)
  // of the row, j = ks / 2: one 16-byte load j serves k-steps 2j and
  // 2j + 1.  B uses the same map.
  uint32_t a[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * kQPW + mt * 16 + h * 8 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < Nq)
          v = __ldg(reinterpret_cast<const uint4*>(
              qb + static_cast<size_t>(row) * kBytes + j * 64 + tig * 16));
        a[mt][2 * j][h] = v.x;
        a[mt][2 * j][2 + h] = v.y;
        a[mt][2 * j + 1][h] = v.z;
        a[mt][2 * j + 1][2 + h] = v.w;
      }
    }
  }

  // [m tile][row g or g + 8], set explicitly: with the member
  // initializers alone the m tile 1 pairs started at 0 on the card, so a
  // split with no valid column gave its queries 16..31 the key 0 (d = 128,
  // an index past the split) instead of the invalid floor
  Top2 top[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      top[mt][h].best = kEmpty;
      top[mt][h].second = kInvalidFloor;
    }
  }
  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int stage = (chunk - c_begin) & 1;
    if (chunk + 1 < c_end) {
      load_chunk(chunk + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const uint4* tile = ring + stage * kChunk * kRowChunks;
    const int2* key = keys + stage * kChunk;
#pragma unroll 2
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      const int r = nt * 8 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 bv =
            tile[r * kRowChunks + ((j * 4 + tig) ^ ((r & 1) << 2))];
        mma_s8(acc[0], a[0][2 * j], bv.x, bv.y);
        mma_s8(acc[1], a[1][2 * j], bv.x, bv.y);
        mma_s8(acc[0], a[0][2 * j + 1], bv.z, bv.w);
        mma_s8(acc[1], a[1][2 * j + 1], bv.z, bv.w);
      }
      // (mul, base) of columns nt*8 + tig*2 and + 1
      const int4 kc =
          *reinterpret_cast<const int4*>(key + nt * 8 + tig * 2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          push(top[mt][h], acc[mt][2 * h] * kc.x + kc.y);
          push(top[mt][h], acc[mt][2 * h + 1] * kc.z + kc.w);
        }
      }
    }
    __syncthreads();   // the next load_chunk overwrites this stage
  }

  const size_t out0 = (static_cast<size_t>(b) * S + split) * Nq;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Top2& s = top[mt][h];
      merge_lane(s, 1);
      merge_lane(s, 2);
      const int row = q0 + warp * kQPW + mt * 16 + h * 8 + g;
      if (tig == mt * 2 + h && row < Nq) {
        best_out[out0 + row] = to_distance(s.best);
        idx_out[out0 + row] =
            s.best == kEmpty ? -1
                             : c_begin * kChunk + kMaxSplitColumns - 1 -
                                   (s.best & (kMaxSplitColumns - 1));
        second_out[out0 + row] = to_distance(s.second);
      }
    }
  }
}

}  // namespace

// q [B?, Nq, 256] int8, t [B?, L, 256] int8 (16-byte aligned), t_valid
// [B?, L] uint8; outputs [B, S, Nq].  A batch stride of 0 shares that
// operand across the batch.  Split s covers landmark chunks
// [s * chunks_per_split, (s + 1) * chunks_per_split) of 128, at most 512.
extern "C" int mslam_hamming_2nn_splits(const void* q, const void* t,
                                        const void* t_valid, void* best,
                                        void* idx, void* second, int B,
                                        int Nq, int L, int S,
                                        int chunks_per_split, long long q_bs,
                                        long long t_bs, long long tv_bs,
                                        void* stream) {
  if (chunks_per_split * kChunk > kMaxSplitColumns)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      hamming_2nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Nq + kQB - 1) / kQB, S, B);
  hamming_2nn_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(t),
      static_cast<const uint8_t*>(t_valid), static_cast<float*>(best),
      static_cast<int*>(idx), static_cast<float*>(second), Nq, L, S,
      chunks_per_split, q_bs, t_bs, tv_bs);
  return static_cast<int>(cudaGetLastError());
}
