// Kernel A: dense FAST-9 score + border mask + fused 3x3 non-max suppression.
//
// Replaces: orb_slam_system_tpu/ops/fast_pallas.py, fast_score_map_pallas
// (Pallas body `_kernel`) called with nms=True. Contract, bit for bit: the
// plain version nms3x3(fast_score_map(img, border)) in
// orb_slam_system_tpu_torch/ops/fast.py. score(p) > t <=> p is a FAST-9
// corner at threshold t; pixels within `border` of the edge score 0 BEFORE
// the NMS (border pixels never suppress interior ones); NMS keeps a pixel
// iff score >= max of its 3x3 neighbourhood.
//
// What bounds it on the card: memory. Each level is read once and written
// once (the largest level is 480x640 f32, 1.2 MB in, 1.2 MB out); the work
// per pixel is 16 subtractions and ~300 min/max, well under the SM's rate.
// The TPU kernel's problem (16 diff planes through VMEM) does not exist
// here: the 16 diffs of one pixel live in registers.
//
// Design: one CTA per (image, 32-row x 64-column tile). The CTA stages the
// tile's pixels with a +-4-row / +-4-column halo in shared memory (40 x 72
// floats: one halo row/column for the NMS plus the ring radius 3), computes
// the score of a 34 x 66 region (the tile plus one halo score on each side,
// so cross-tile NMS neighbours are seen), then applies the 3x3 NMS from
// shared memory. Only subtract, negate, min and max are used, so the result
// is exact whatever the evaluation order. One launch per pyramid level.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 64;
constexpr int RING = 3;
constexpr int SCORE_H = TILE_H + 2;             // scores for rows -1..TILE_H
constexpr int SCORE_W = TILE_W + 2;
constexpr int PIX_H = SCORE_H + 2 * RING;       // 40
constexpr int PIX_W = SCORE_W + 2 * RING;       // 72
constexpr int THREADS = 256;
constexpr int ARC = 9;                          // FAST-9

// Bresenham circle of radius 3 in circular order (ops/fast.py CIRCLE).
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

__global__ void __launch_bounds__(THREADS)
fast_score_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                      int H, int W, int border) {
  __shared__ float pix[PIX_H][PIX_W];
  __shared__ float score[SCORE_H][SCORE_W];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const float* im = img + static_cast<size_t>(b) * H * W;

  // Stage pixels. Coordinates are clamped into the image: a clamped value
  // only ever feeds a score that the border mask sets to 0.
  for (int i = threadIdx.x; i < PIX_H * PIX_W; i += THREADS) {
    const int r = i / PIX_W, c = i % PIX_W;
    const int gy = min(max(y0 - 1 - RING + r, 0), H - 1);
    const int gx = min(max(x0 - 1 - RING + c, 0), W - 1);
    pix[r][c] = im[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < SCORE_H * SCORE_W; i += THREADS) {
    const int r = i / SCORE_W, c = i % SCORE_W;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float s = 0.0f;
    if (gy >= border && gy < H - border && gx >= border && gx < W - border) {
      const float center = pix[r + RING][c + RING];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = pix[r + RING + kRingDy[k]][c + RING + kRingDx[k]] - center;
      float bright = -CUDART_INF_F, dark = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float mn = d[k], mx = d[k];
#pragma unroll
        for (int j = 1; j < ARC; ++j) {
          const float v = d[(k + j) & 15];
          mn = fminf(mn, v);
          mx = fmaxf(mx, v);
        }
        bright = fmaxf(bright, mn);   // ring brighter than centre
        dark = fmaxf(dark, -mx);      // ring darker: min(-d) == -max(d)
      }
      s = fmaxf(bright, dark);
    }
    score[r][c] = s;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += THREADS) {
    const int r = i / TILE_W, c = i % TILE_W;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    const float s = score[r + 1][c + 1];
    float pooled = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        pooled = fmaxf(pooled, score[r + dy][c + dx]);
    out[static_cast<size_t>(b) * H * W + static_cast<size_t>(gy) * W + gx] =
        (s >= pooled) ? s : 0.0f;
  }
}

}  // namespace

extern "C" int orb_fast_score_nms(const float* img, float* out, int B, int H,
                                  int W, int border, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  fast_score_nms_kernel<<<grid, THREADS, 0, stream>>>(img, out, H, W, border);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* orb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
