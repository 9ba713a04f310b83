// Kernel C: rotated BRIEF by direct compare, packed into 8 x 32-bit words.
//
// Replaces: orb_slam_system_tpu/ops/brief_pallas.py, binned_diffs_pallas
// (Pallas body `_kernel`: bin-sorted bf16 [128,1408] x [1408,256] +-1 test
// matrices on the MXU) together with the bin sort around it
// (ops/brief.py compute_descriptors). Every column of a test matrix holds
// one +1 at p2 and one -1 at p1, so each descriptor bit is simply
//     bf16(I[p2]) > bf16(I[p1])
// at the keypoint's angle-bin-rotated offsets: no GEMM and no sort. The
// bf16 rounding is part of the descriptor's definition (a compare in f32
// flips bits). Contract, bit for bit: brief_pack_plain in
// orb_slam_system_tpu_torch/ops/brief.py and the JAX oracle
// compute_descriptors_dense.
//
// What bounds it on the card: latency of 512 dependent-free loads per
// keypoint from a 5.5 KB blurred patch (1024 keypoints read 5.6 MB, all
// L2-resident after kernel B wrote them); the arithmetic is trivial.
// Design: one warp per keypoint. Lane l evaluates bit l of each of the 8
// words, and __ballot_sync packs the word (bit i of word w = test w*32+i).
// The rotated offsets come from the int8[32,256,4] table built on the host
// with the exact rotation and Python rounding of ops/brief.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PB = 37;                   // blurred patch side (radius 18)
constexpr int N_BINS = 32;
constexpr int N_BITS = 256;
constexpr int THREADS = 256;
// f32(32 / 2pi), the same constant ops/brief._angle_bins multiplies by.
constexpr float kBinScale = static_cast<float>(32.0 / (2.0 * 3.14159265358979323846));

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS)
brief_pack_kernel(const float* __restrict__ blurred,
                  const float* __restrict__ angle,
                  const signed char* __restrict__ table,
                  int* __restrict__ desc, int M) {
  const int kp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (kp >= M) return;                   // uniform across the warp
  int bin = static_cast<int>(rintf(__fmul_rn(angle[kp], kBinScale)));
  bin = ((bin % N_BINS) + N_BINS) % N_BINS;
  const float* p = blurred + static_cast<size_t>(kp) * PB * PB;
  const signed char* t = table + static_cast<size_t>(bin) * N_BITS * 4;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const signed char* q = t + (w * 32 + lane) * 4;   // x1, y1, x2, y2
    const float v1 = bf16_round(p[q[1] * PB + q[0]]);
    const float v2 = bf16_round(p[q[3] * PB + q[2]]);
    const unsigned word = __ballot_sync(0xffffffffu, v2 > v1);
    if (lane == 0) desc[kp * 8 + w] = static_cast<int>(word);
  }
}

}  // namespace

extern "C" int orb_brief_pack(const float* blurred, const float* angle,
                              const signed char* table, int* desc, int M,
                              cudaStream_t stream) {
  if (M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  const int warps_per_block = THREADS / 32;
  const int grid = (M + warps_per_block - 1) / warps_per_block;
  brief_pack_kernel<<<grid, THREADS, 0, stream>>>(blurred, angle, table, desc, M);
  return static_cast<int>(cudaGetLastError());
}
