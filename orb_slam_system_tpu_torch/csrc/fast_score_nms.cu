// Kernel A: dense FAST-9 score + border mask + fused 3x3 non-max suppression,
// for every pyramid level in one launch.
//
// Replaces: orb_slam_system_tpu/ops/fast_pallas.py, fast_score_map_pallas
// (Pallas body `_kernel`) called with nms=True, once per level. Contract,
// bit for bit, on each level: the plain version
// nms3x3(fast_score_map(img, border)) in orb_slam_system_tpu_torch/ops/fast.py.
// score(p) > t <=> p is a FAST-9 corner at threshold t; pixels within
// `border` of the edge score 0 BEFORE the NMS (border pixels never suppress
// interior ones); NMS keeps a pixel iff score >= max of its 3x3
// neighbourhood.
//
// What bounds it on the card: arithmetic, then launches. The 8 levels of a
// 640x480 frame are 0.95 M pixels, read once and written once (7.6 MB), a
// couple of microseconds of memory time; the segment test is ~110 min/max
// per pixel, and min/max issue at half the f32 add rate. One launch per
// level also cost a host round trip each, and the small levels alone fill
// few SMs (the 179x134 level is 15 tiles for 132 SMs).
//
// Design:
//  * One launch covers all levels. The level table (input and output
//    pointers, H, W, tiles across, first tile) is a kernel parameter passed
//    by value; the 1-D grid runs over every level's 32x64 tiles, batch on
//    blockIdx.y (512 CTAs at 640x480). Each CTA finds its level from the
//    first-tile prefix with compile-time indices only, so the table stays
//    in the constant bank. The tile plan is made in ops/fast.py
//    (`tile_plan`) and checked here.
//  * A CTA stages its tile's pixels with a +-4 halo in shared memory (40 x
//    72 floats: one halo score for the NMS plus the ring radius 3), scores a
//    34 x 66 region so cross-tile NMS neighbours are seen, then applies the
//    3x3 NMS from shared memory.
//  * The segment test takes the circular windowed min/max of the 16 ring
//    differences by doubling, as fast_pallas.py does (windows of 2, 4, 8,
//    then 9), sharing each odd-start 8-window between the two 9-windows
//    that contain it: ~110 operations per pixel instead of ~300. Only
//    subtract, negate, min and max are used, so the result is exact in any
//    order.

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
constexpr int MAX_LEVELS = 16;

// Bresenham circle of radius 3 in circular order (ops/fast.py CIRCLE).
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

}  // namespace

// The level table; ops/fast.py mirrors this layout as a ctypes Structure.
struct FastLevels {
  const float* src[MAX_LEVELS];   // level l, f32[B, H[l], W[l]]
  float* dst[MAX_LEVELS];         // its NMS'd score map, same shape
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];        // ceil(W / TILE_W)
  int first_tile[MAX_LEVELS + 1]; // prefix of per-level tile counts
  int n_levels;
  int border;
};

namespace {

// FAST-9 score of one pixel from its 16 ring-minus-centre differences:
// max over the 16 circular 9-arcs of min(d) (ring brighter) and of -max(d)
// (ring darker). lo8[j] / hi8[j] is the min / max over d[2j+1 .. 2j+8];
// the 9-arcs starting at 2j and 2j+1 are that 8-window plus d[2j] or
// d[2j+9], so max(min(w, d[2j]), min(w, d[2j+9])) = min(w, max(d[2j],
// d[2j+9])), and the dark side likewise with min and max swapped.
__device__ __forceinline__ float segment_score(const float d[16]) {
  float lo2[8], hi2[8], lo4[8], hi4[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lo2[j] = fminf(d[2 * j + 1], d[(2 * j + 2) & 15]);
    hi2[j] = fmaxf(d[2 * j + 1], d[(2 * j + 2) & 15]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lo4[j] = fminf(lo2[j], lo2[(j + 1) & 7]);
    hi4[j] = fmaxf(hi2[j], hi2[(j + 1) & 7]);
  }
  float bright = -CUDART_INF_F, dark = CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float lo8 = fminf(lo4[j], lo4[(j + 2) & 7]);
    const float hi8 = fmaxf(hi4[j], hi4[(j + 2) & 7]);
    const float a = d[2 * j], c = d[(2 * j + 9) & 15];
    bright = fmaxf(bright, fminf(lo8, fmaxf(a, c)));
    dark = fminf(dark, fmaxf(hi8, fminf(a, c)));
  }
  return fmaxf(bright, -dark);
}

__global__ void __launch_bounds__(THREADS)
fast_score_nms_kernel(const FastLevels t) {
  __shared__ float pix[PIX_H][PIX_W];
  __shared__ float score[SCORE_H][SCORE_W];
  // This CTA's level: the last one whose first tile is <= blockIdx.x.
  const int tile = blockIdx.x;
  const float* src = t.src[0];
  float* dst = t.dst[0];
  int H = t.H[0], W = t.W[0], tiles_x = t.tiles_x[0], first = 0;
#pragma unroll
  for (int l = 1; l < MAX_LEVELS; ++l) {
    if (l < t.n_levels && tile >= t.first_tile[l]) {
      src = t.src[l];
      dst = t.dst[l];
      H = t.H[l];
      W = t.W[l];
      tiles_x = t.tiles_x[l];
      first = t.first_tile[l];
    }
  }
  const int border = t.border;
  const int local = tile - first;
  const int y0 = (local / tiles_x) * TILE_H;
  const int x0 = (local - (local / tiles_x) * tiles_x) * TILE_W;
  const size_t plane = static_cast<size_t>(blockIdx.y) * H * W;
  const float* im = src + plane;

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
      s = segment_score(d);
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
    dst[plane + static_cast<size_t>(gy) * W + gx] = (s >= pooled) ? s : 0.0f;
  }
}

}  // namespace

// One launch over every level of `levels` (a host struct, copied into the
// kernel's parameters). Refuses a table whose tile plan does not match
// TILE_H x TILE_W tiles.
extern "C" int orb_fast_score_nms(const FastLevels* levels, int B,
                                  cudaStream_t stream) {
  const FastLevels& t = *levels;
  if (B <= 0 || B > 65535 || t.n_levels <= 0 || t.n_levels > MAX_LEVELS ||
      t.first_tile[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < t.n_levels; ++l) {
    const int tx = (t.W[l] + TILE_W - 1) / TILE_W;
    const int ty = (t.H[l] + TILE_H - 1) / TILE_H;
    if (t.H[l] <= 0 || t.W[l] <= 0 || t.tiles_x[l] != tx ||
        t.first_tile[l + 1] - t.first_tile[l] != tx * ty ||
        t.src[l] == nullptr || t.dst[l] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(t.first_tile[t.n_levels], B);
  fast_score_nms_kernel<<<grid, THREADS, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* orb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
