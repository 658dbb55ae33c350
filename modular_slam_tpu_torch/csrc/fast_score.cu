// FAST-9/16 corner-score maps of a whole image pyramid in one launch,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel modular_slam_tpu/ops/fast_pallas.py
// (_fast_kernel, :49), which the JAX detector calls once per pyramid level.
// Per pixel p, with d_k = I(p + c_k) - I(p) over the 16-pixel Bresenham
// circle c_k of radius 3:
//   score = max(0, max_k min_{j<9} d_{k+j}, -min_k max_{j<9} d_{k+j}),
// k + j taken circularly.  A pixel is a FAST-9 corner at threshold t
// exactly when score > t.
//
// What bounds it on this card: a 640x480 frame's 8 levels are 950,532
// pixels, 7.6 MB read and written once, 2.3 us at 3.35 TB/s.  The ladders
// below are min/max, which an SM issues at 64 per clock, a quarter of the
// f32 FMA rate: at that rate they take longer than the memory does
// (chip_smoke.py reports both).  At these sizes the launch itself costs as
// much as the work, so the design removes launches first:
//   - one launch covers every level (up to kMaxLevels) and a batch of
//     frames: the levels' tiles are numbered one after the other, the
//     host passes each level's first tile index, and a block finds its
//     level by scanning that prefix (a branch uniform over the block);
//   - a block of 32x8 threads computes a 32x32 tile, each thread 4 rows
//     8 apart, so the 3-pixel halo it stages in shared memory costs 1.4x
//     the tile's loads (38*38 / 32*32) instead of 2.1x for a 32x8 tile;
//   - the halo wraps by compare-and-add, once per column and once per
//     row a thread loads, not `%` on every load;
//   - the circular min-9 / max-9 windows come from a pair/quad ladder:
//     with p_i = min(d[2i+1], d[2i+2]), q_i = min(p_i, p_{i+1}) and
//     m_i = min(q_i, q_{i+2}) = min d[2i+1 .. 2i+8], the 16 windows are
//     min(d[2i], m_i) and min(m_i, d[2i+9]), and the best of each pair is
//     min(m_i, max(d[2i], d[2i+9])): 47 min/max for all of `bright` where
//     the direct ladder takes 143.  min and max are exact, so any grouping
//     gives the same scores bit for bit;
//   - a ladder runs only where a pair of compass pixels allows its arc
//     (the first test of OpenCV's FAST): elsewhere it cannot raise the
//     score above 0, so skipping it changes no score.
//
// Border rule: neighbours wrap around the image edges, exactly like the
// plain version's torch.roll (ops/fast.py), so kernel and plain version
// agree on every pixel.  (The Pallas kernel differs from the plain version
// within 3 px of the edges; the detector masks a >= 19 px border.)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kHalo = 3;
constexpr int kTile = 32;            // output tile is kTile x kTile
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTile / kThreadsY;
constexpr int kSmem = kTile + 2 * kHalo;

struct Levels {
  const float* src[kMaxLevels];
  float* dst[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  int first_tile[kMaxLevels + 1];   // prefix of the levels' tile counts
  int n;
};

// v in [-n, 2n) -> v mod n by one compare-and-add each way; anything
// further out (images smaller than the halo, or halo rows that no output
// pixel reads) takes the modulo.
__device__ __forceinline__ int wrap(int v, int n) {
  v += v < 0 ? n : 0;
  v -= v >= n ? n : 0;
  if (static_cast<unsigned>(v) >= static_cast<unsigned>(n)) {
    v %= n;
    v += v < 0 ? n : 0;
  }
  return v;
}

// min over a circular window of 9, for all 16 starts, then max over starts
template <bool kMin>
__device__ __forceinline__ float ladder(const float (&d)[16]) {
  auto lo = [](float a, float b) { return kMin ? fminf(a, b) : fmaxf(a, b); };
  auto hi = [](float a, float b) { return kMin ? fmaxf(a, b) : fminf(a, b); };
  float p[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = lo(d[2 * i + 1], d[(2 * i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = lo(p[i], p[(i + 1) & 7]);
  float acc = kMin ? -INFINITY : INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float m = lo(q[i], q[(i + 2) & 7]);   // d[2i+1 .. 2i+8]
    // windows starting at 2i and 2i+1: hi(lo(d[2i], m), lo(m, d[2i+9]))
    acc = hi(acc, lo(m, hi(d[2 * i], d[(2 * i + 9) & 15])));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
fast_score_levels_kernel(const Levels lv) {
  __shared__ float tile[kSmem][kSmem];

  const int blk = blockIdx.x;
  int l = 0;
  while (l + 1 < lv.n && blk >= lv.first_tile[l + 1]) ++l;
  const int H = lv.H[l];
  const int W = lv.W[l];
  const int tiles_x = (W + kTile - 1) / kTile;
  const int t = blk - lv.first_tile[l];
  const int y0 = (t / tiles_x) * kTile;
  const int x0 = (t % tiles_x) * kTile;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* src = lv.src[l] + blockIdx.y * plane;
  float* dst = lv.dst[l] + blockIdx.y * plane;

  // halo columns wrap once per thread, rows once per pass
  int gx[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    gx[k] = wrap(x0 + threadIdx.x + k * kThreadsX - kHalo, W);
  for (int r = threadIdx.y; r < kSmem; r += kThreadsY) {
    const float* row =
        src + static_cast<size_t>(wrap(y0 + r - kHalo, H)) * W;
    tile[r][threadIdx.x] = row[gx[0]];
    if (threadIdx.x + kThreadsX < kSmem)
      tile[r][threadIdx.x + kThreadsX] = row[gx[1]];
  }
  __syncthreads();

  // Bresenham circle of radius 3 in circular order (dy, dx): the same
  // table as FAST_CIRCLE in ops/fast.py
  constexpr int cdy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                           3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int cdx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                           0, -1, -2, -3, -3, -3, -2, -1};
  const int x = x0 + threadIdx.x;
  const int tx = threadIdx.x + kHalo;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int ry = threadIdx.y + j * kThreadsY;
    const int y = y0 + ry;
    if (x >= W || y >= H) continue;
    const int ty = ry + kHalo;
    const float center = tile[ty][tx];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      d[k] = tile[ty + cdy[k]][tx + cdx[k]] - center;
    // Any 9 consecutive circle pixels hold two compass pixels 4 apart, so
    // bright > 0 needs such a pair with both d > 0 (dark: both < 0).
    // Without one that ladder is <= 0 and leaves max(., 0) unchanged.
    const bool b0 = d[0] > 0.0f, b4 = d[4] > 0.0f, b8 = d[8] > 0.0f,
               b12 = d[12] > 0.0f;
    const bool k0 = d[0] < 0.0f, k4 = d[4] < 0.0f, k8 = d[8] < 0.0f,
               k12 = d[12] < 0.0f;
    float score = 0.0f;
    if ((b0 && b4) || (b4 && b8) || (b8 && b12) || (b12 && b0))
      score = fmaxf(score, ladder<true>(d));     // bright = max_k min9
    if ((k0 && k4) || (k4 && k8) || (k8 && k12) || (k12 && k0))
      score = fmaxf(score, -ladder<false>(d));   // dark = -min_k max9
    dst[static_cast<size_t>(y) * W + x] = score;
  }
}

}  // namespace

// srcs / dsts: n device pointers to contiguous [B, H_l, W_l] float32
// planes; first_tile: n + 1 ints, the prefix of ceil(H/32) * ceil(W/32)
// over the levels (ops/fast.py fast_tile_table builds it).
extern "C" int mslam_fast_score_levels(const void* const* srcs,
                                       void* const* dsts, const int* Hs,
                                       const int* Ws, const int* first_tile,
                                       int n, int B, void* stream) {
  if (n < 1 || n > kMaxLevels || B < 1) return static_cast<int>(
      cudaErrorInvalidValue);
  Levels lv;
  lv.n = n;
  for (int l = 0; l < n; ++l) {
    lv.src[l] = static_cast<const float*>(srcs[l]);
    lv.dst[l] = static_cast<float*>(dsts[l]);
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
  }
  for (int l = 0; l <= n; ++l) lv.first_tile[l] = first_tile[l];
  if (lv.first_tile[n] < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreadsX, kThreadsY, 1);
  const dim3 grid(lv.first_tile[n], B, 1);
  fast_score_levels_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(lv);
  return static_cast<int>(cudaGetLastError());
}
