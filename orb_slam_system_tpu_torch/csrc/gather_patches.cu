// Kernel D: raw square-patch gather around integer keypoint centres.
//
// Replaces: orb_slam_system_tpu/ops/gather_pallas.py, gather_patches_pallas
// (Pallas body `_kernel`: per-keypoint aligned HBM->VMEM window DMAs and
// dynamic rolls to the exact patch). Contract, bit for bit: the plain
// version gather_patches_plain in orb_slam_system_tpu_torch/ops/patches.py
// (the JAX package's ops/patches.gather_patches):
//   x0 = clamp(x - r, 0, W - P), y0 = clamp(y - r, 0, H - P), P = 2r + 1,
//   out[b, n, i, j] = img[b, y0 + i, x0 + j]
// for any radius r with P <= H and P <= W. A pure copy, so it is exact by
// construction.
//
// What bounds it on the card: bytes. On the extractor's unfused route the
// canvas of a 640x480 frame (646 x 2280 f32, 5.9 MB) is read and 1024
// patches of 43x43 f32 (7.6 MB) are written; there is no arithmetic. The
// canvas sits in the 50 MB L2, so a patch row read more than once (patches
// overlap) costs L2 bandwidth, not device-memory bandwidth. The TPU's
// aligned DMA windows and rolls have no counterpart here: a thread reads
// any address.
//
// Design: one CTA of 256 threads per (image, group of KPB keypoints).
// Threads walk the patch in row-major order, so a warp reads consecutive
// columns of one patch row (coalesced up to the row's end) and writes
// consecutive output floats.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int KPB = 4;                   // keypoints per CTA

__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const float* __restrict__ img,
                      const int* __restrict__ xy,
                      float* __restrict__ out,
                      int N, int H, int W, int radius) {
  const int P = 2 * radius + 1;
  const int PP = P * P;
  const int b = blockIdx.y;
  const float* im = img + static_cast<size_t>(b) * H * W;
  for (int kk = 0; kk < KPB; ++kk) {
    const int k = blockIdx.x * KPB + kk;
    if (k >= N) break;
    const size_t kp = static_cast<size_t>(b) * N + k;
    const int x0 = min(max(xy[2 * kp] - radius, 0), W - P);
    const int y0 = min(max(xy[2 * kp + 1] - radius, 0), H - P);
    float* o = out + kp * PP;
    for (int i = threadIdx.x; i < PP; i += THREADS) {
      const int r = i / P, c = i - r * P;
      o[i] = __ldg(im + static_cast<size_t>(y0 + r) * W + x0 + c);
    }
  }
}

}  // namespace

extern "C" int orb_gather_patches(const float* img, const int* xy, float* out,
                                  int B, int N, int H, int W, int radius,
                                  cudaStream_t stream) {
  const int P = 2 * radius + 1;
  if (radius < 0 || H < P || W < P || B <= 0 || N < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N + KPB - 1) / KPB, B);
  gather_patches_kernel<<<grid, THREADS, 0, stream>>>(img, xy, out, N, H, W,
                                                      radius);
  return static_cast<int>(cudaGetLastError());
}
