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
// Design: the grid covers the flat [B, N, P, P] output, each thread
// producing VEC = 4 consecutive floats. A thread issues its four loads
// before its store, so each warp keeps 128 independent reads in flight;
// the store is one 16-byte write (the output base is 256-byte aligned and
// the thread's offset a multiple of 4), coalesced across the warp. The
// element -> (keypoint, row, column) split divides by the patch side;
// radius 21 (the extractor's 43x43) is its own instantiation, so those
// divisions are by constants; any other radius takes the generic one.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                   // consecutive outputs per thread

// kP > 0: patch side known at compile time; kP == 0: runtime side `p`.
template <int kP>
__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const float* __restrict__ img,
                      const int2* __restrict__ xy,
                      float* __restrict__ out,
                      int total, int N, int H, int W, int p) {
  const int P = kP > 0 ? kP : p;
  const int PP = P * P;
  const int radius = (P - 1) / 2;
  const int e0 = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (e0 >= total) return;
  // Split the first element once; the next ones step along the row.
  int kp = e0 / PP;                              // b * N + n
  const int rem = e0 - kp * PP;
  int r = rem / P, c = rem - r * P;
  int b = kp / N;
  float v[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int2 k = __ldg(xy + kp);
    const int x0 = min(max(k.x - radius, 0), W - P);
    const int y0 = min(max(k.y - radius, 0), H - P);
    v[j] = __ldg(img + (static_cast<size_t>(b) * H + y0 + r) * W + x0 + c);
    if (++c == P) {
      c = 0;
      if (++r == P) {
        r = 0;
        // Past the last keypoint only on the masked tail: stay in bounds.
        if (e0 + j + 1 < total && ++kp - b * N == N) ++b;
      }
    }
  }
  if (e0 + VEC <= total) {
    *reinterpret_cast<float4*>(out + e0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (e0 + j < total) out[e0 + j] = v[j];
  }
}

}  // namespace

extern "C" int orb_gather_patches(const float* img, const int* xy, float* out,
                                  int B, int N, int H, int W, int radius,
                                  cudaStream_t stream) {
  const int P = 2 * radius + 1;
  // xy is read as int2 and out written as float4: 8- and 16-byte aligned.
  if (radius < 0 || H < P || W < P || B <= 0 || N < 0 ||
      (reinterpret_cast<size_t>(xy) & 7) != 0 ||
      (reinterpret_cast<size_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * N * P * P;
  if (total > INT_MAX - THREADS * VEC)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int blocks = static_cast<int>((total + THREADS * VEC - 1) / (THREADS * VEC));
  const int2* xy2 = reinterpret_cast<const int2*>(xy);
  if (P == 43)
    gather_patches_kernel<43><<<blocks, THREADS, 0, stream>>>(
        img, xy2, out, static_cast<int>(total), N, H, W, P);
  else
    gather_patches_kernel<0><<<blocks, THREADS, 0, stream>>>(
        img, xy2, out, static_cast<int>(total), N, H, W, P);
  return static_cast<int>(cudaGetLastError());
}
