// FAST-9/16 corner-score map, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel modular_slam_tpu/ops/fast_pallas.py
// (_fast_kernel, :49).  Per pixel p, with d_k = I(p + c_k) - I(p) over the
// 16-pixel Bresenham circle c_k of radius 3:
//   score = max(0, max_k min_{j<9} d_{k+j}, -min_k max_{j<9} d_{k+j}),
// k + j taken circularly.  A pixel is a FAST-9 corner at threshold t
// exactly when score > t.
//
// What bounds it on this card: memory, and at the pyramid's sizes launch
// latency.  Each pixel needs 17 reads and ~290 min/max/sub operations;
// the image (1.2 MB at 640x480 float32) is read once from device memory
// and the scores written once.  Design: one thread per output pixel; a
// 32x8 block stages its tile plus a 3-pixel halo on every side in shared
// memory (the 16 neighbours of a pixel are then shared-memory reads), and
// the 16 differences and the circular min-9 / max-9 ladders stay in
// registers.  The batch dimension [B, H, W] is the grid's z, which
// replaces the Pallas kernel's custom_vmap workaround.
//
// Border rule: neighbours wrap around the image edges, exactly like the
// plain version's jnp.roll / torch.roll (ops/fast.py), so kernel and plain
// version agree on every pixel.  (The Pallas kernel differs from the plain
// version within 3 px of the edges; the detector masks a >= 19 px border.)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHalo = 3;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kSmemW = kTileW + 2 * kHalo;
constexpr int kSmemH = kTileH + 2 * kHalo;

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__global__ void __launch_bounds__(kTileW * kTileH)
fast_score_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int H, int W) {
  __shared__ float tile[kSmemH][kSmemW];

  const size_t plane = static_cast<size_t>(H) * W;
  const float* src = img + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kSmemH * kSmemW; i += kTileW * kTileH) {
    const int r = i / kSmemW;
    const int c = i - r * kSmemW;
    const int gy = wrap(y0 + r - kHalo, H);
    const int gx = wrap(x0 + c - kHalo, W);
    tile[r][c] = src[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;

  // Bresenham circle of radius 3 in circular order (dy, dx) — the same
  // table as FAST_CIRCLE in ops/fast.py
  const int cdy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int cdx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

  const int ty = threadIdx.y + kHalo;
  const int tx = threadIdx.x + kHalo;
  const float center = tile[ty][tx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = tile[ty + cdy[k]][tx + cdx[k]] - center;

  float bright = -INFINITY;    // max_k min9(d)
  float min_of_max = INFINITY; // min_k max9(d); dark = -min_of_max
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float wmin = d[k];
    float wmax = d[k];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float dj = d[(k + j) & 15];
      wmin = fminf(wmin, dj);
      wmax = fmaxf(wmax, dj);
    }
    bright = fmaxf(bright, wmin);
    min_of_max = fminf(min_of_max, wmax);
  }
  dst[static_cast<size_t>(y) * W + x] =
      fmaxf(fmaxf(bright, -min_of_max), 0.0f);
}

}  // namespace

extern "C" int mslam_fast_score(const void* img, void* out, int B, int H,
                                int W, void* stream) {
  const dim3 block(kTileW, kTileH, 1);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
