// Kernel B: per-keypoint 43x43 patch gather + 7x7 sigma=2 blur + IC moments.
//
// Replaces: orb_slam_system_tpu/ops/gather_pallas.py,
// gather_blur_moments_pallas (Pallas bodies `_kernel_fused_resident` and
// `_kernel_fused`; the TPU splits them by whether the canvas fits VMEM).
// Contract: the plain version gather_blur_moments_plain in
// orb_slam_system_tpu_torch/ops/patches.py. Per keypoint, from the
// all-level reflect-padded canvas:
//   * the 43x43 patch whose start is clipped into the canvas exactly as
//     ops/patches.gather_patches does;
//   * the valid-mode separable 7x7 blur to 37x37, rows first and then
//     columns, each output summed in tap order 0..6 with separate rounding
//     of every product and sum (no FMA: __fmul_rn/__fadd_rn, and the file
//     builds with -fmad=false) -- bit-exact against the plain version;
//   * the moments (m10, m01) of the UNBLURRED circular 31x31 centre with the
//     moment_weights() tables. They come from a block reduction whose
//     summation order differs from the plain version's, so they agree to a
//     tolerance, not bit for bit.
//
// What bounds it on the card: latency of the gathers, not bandwidth. The
// whole 8-level canvas of a 640x480 frame (2280 x 646 f32, 5.9 MB) sits in
// the 50 MB L2, so the TPU's resident/windowed split has no counterpart: one
// kernel. A keypoint reads 7.4 KB and writes 5.5 KB; ~0.2 MFLOP per
// keypoint of blur. Design: one CTA of 256 threads per keypoint; the patch
// and the row-pass intermediate (37x43) live in shared memory (13.8 KB), so
// the raw patch never goes to device memory.

#include <cuda_runtime.h>

namespace {

constexpr int RADIUS = 21;
constexpr int P = 2 * RADIUS + 1;       // 43: gathered patch
constexpr int PB = P - 6;               // 37: blurred (valid 7-tap)
constexpr int PO = 31;                  // IC-angle window (HALF_PATCH 15)
constexpr int CO = (P - PO) / 2;        // 6: its offset in the patch
constexpr int TAPS = 7;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
gather_blur_moments_kernel(const float* __restrict__ canvas,
                           const int* __restrict__ xy,
                           const float* __restrict__ taps,
                           const float* __restrict__ wxy,
                           float* __restrict__ blurred,
                           float* __restrict__ moments,
                           int N, int H, int W) {
  __shared__ float patch[P * P];
  __shared__ float rows[PB * P];
  __shared__ float red[2][WARPS];
  const int kp = blockIdx.x;                 // flat (image, keypoint)
  const int b = kp / N;
  const int x0 = min(max(xy[2 * kp] - RADIUS, 0), W - P);
  const int y0 = min(max(xy[2 * kp + 1] - RADIUS, 0), H - P);
  const float* im = canvas + static_cast<size_t>(b) * H * W;

  for (int i = threadIdx.x; i < P * P; i += THREADS)
    patch[i] = im[static_cast<size_t>(y0 + i / P) * W + x0 + i % P];
  float k[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) k[t] = taps[t];
  __syncthreads();

  // IC moments over the circular centre of the unblurred patch.
  float m10 = 0.0f, m01 = 0.0f;
  for (int i = threadIdx.x; i < PO * PO; i += THREADS) {
    const float v = patch[(CO + i / PO) * P + CO + i % PO];
    m10 += v * wxy[i];
    m01 += v * wxy[PO * PO + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_down_sync(0xffffffffu, m10, off);
    m01 += __shfl_down_sync(0xffffffffu, m01, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = m10;
    red[1][threadIdx.x >> 5] = m01;
  }

  // Row pass: rows[r][c] = sum_t patch[r + t][c] * k[t], t = 0..6 in order.
  for (int i = threadIdx.x; i < PB * P; i += THREADS) {
    const int r = i / P, c = i % P;
    float acc = __fmul_rn(patch[r * P + c], k[0]);
#pragma unroll
    for (int t = 1; t < TAPS; ++t)
      acc = __fadd_rn(acc, __fmul_rn(patch[(r + t) * P + c], k[t]));
    rows[i] = acc;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    float s10 = 0.0f, s01 = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      s10 += red[0][w];
      s01 += red[1][w];
    }
    moments[2 * kp] = s10;
    moments[2 * kp + 1] = s01;
  }

  // Column pass: out[r][c] = sum_t rows[r][c + t] * k[t].
  float* out = blurred + static_cast<size_t>(kp) * PB * PB;
  for (int i = threadIdx.x; i < PB * PB; i += THREADS) {
    const int r = i / PB, c = i % PB;
    const float* src = rows + r * P + c;
    float acc = __fmul_rn(src[0], k[0]);
#pragma unroll
    for (int t = 1; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(src[t], k[t]));
    out[i] = acc;
  }
}

}  // namespace

extern "C" int orb_gather_blur_moments(const float* canvas, const int* xy,
                                       const float* taps, const float* wxy,
                                       float* blurred, float* moments, int B,
                                       int N, int H, int W, int radius,
                                       cudaStream_t stream) {
  if (radius != RADIUS || H < P || W < P || B <= 0 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  gather_blur_moments_kernel<<<B * N, THREADS, 0, stream>>>(
      canvas, xy, taps, wxy, blurred, moments, N, H, W);
  return static_cast<int>(cudaGetLastError());
}
