// Kernel B: per-keypoint 43x43 patch gather + 7x7 sigma=2 blur + IC moments,
// and, in its describe mode, the IC angle and the rBRIEF descriptor too.
//
// Replaces: orb_slam_system_tpu/ops/gather_pallas.py,
// gather_blur_moments_pallas (Pallas bodies `_kernel_fused_resident` and
// `_kernel_fused`; the TPU splits them by whether the canvas fits VMEM).
// Two compile-time modes of one kernel, one reduction for both:
//   * blur (orb_gather_blur_moments): the TPU kernel's contract, blurred
//     f32[B,N,37,37] + moments f32[B,N,2]. Contract: the plain version
//     gather_blur_moments_plain in orb_slam_system_tpu_torch/ops/patches.py.
//   * describe (orb_gather_blur_describe): moments f32[B,N,2], angle
//     f32[B,N] and descriptor i32[B,N,8]; no blurred patch leaves the SM.
//     Contract: gather_blur_describe_plain, i.e. gather_blur_moments_plain
//     -> angles_from_moments -> brief_pack_plain (kernel C's contract,
//     csrc/brief_pack.cu).
// Per keypoint, from the all-level reflect-padded canvas:
//   * the 43x43 patch whose start is clipped into the canvas exactly as
//     ops/patches.gather_patches does;
//   * the valid-mode separable 7x7 blur to 37x37, rows first and then
//     columns, each output summed in tap order 0..6 with separate rounding
//     of every product and sum (__fmul_rn/__fadd_rn, never contracted) --
//     bit-exact against the plain version;
//   * the moments (m10, m01) = sum of (dx, dy) * pixel over the UNBLURRED
//     circle |dx| <= umax[|dy|] of radius 15 (orientation.moment_weights);
//     the circle is symmetric in dx and dy, so a column dx holds the rows
//     |dy| <= umax[|dx|]. Their summation order differs from the plain
//     version's, so they agree to a tolerance, not bit for bit; both modes
//     share the reduction, so their moments are equal bit for bit;
//   * describe: angle = atan2f(m01, m10), plus f32(2 pi) when negative (as
//     angles_from_moments), its bin as brief._angle_bins, and bit i of word
//     w = bf16(I[p2]) > bf16(I[p1]) for test w*32 + i at the bin's rows of
//     the int8 offset table, packed with __ballot_sync.
//
// What bounds it on the card: the bytes of the canvas (5.9 MB at 640x480, 8
// levels; it sits in the 50 MB L2) set the bound, the latency of the patch
// loads the time: on an H100 a copy of this kernel that only loads the
// patches and reduces the moments takes about half of it (PERF.md). The
// design keeps every intermediate on the SM: one CTA of 3 warps per
// keypoint. Thread (c, h) holds column c of the patch, rows 18h..18h+24, in
// registers -- its 25 loads are all issued before the first use, each
// coalesced across the lanes of a row -- and from them adds its column's
// part of the moments and runs the column-wise (first) blur pass for 19
// output rows, a sliding window over registers, into shared memory
// (37x43 f32, 6.4 KB). Two threads per column keep more loads in flight
// than one (2 warps, one whole column each, measured slower). The warps
// reduce the moments with xor shuffles (all lanes end with the same sum)
// and add the 3 warp sums in a fixed order. The row-wise (second) pass then
// runs only where it is read: at all 37x37 outputs in blur mode, at the 512
// test points of the keypoint's bin in describe mode (512 x 7 taps against
// 1,369 x 7), so a test point's value is bit-identical to the full blur's.
// The moment weights are (dx, dy) themselves and the umax table a 64-bit
// constant: nothing but the canvas, the centres, 7 taps and 1 KB of the
// offset table is read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int RADIUS = 21;
constexpr int P = 2 * RADIUS + 1;       // 43: gathered patch
constexpr int TAPS = 7;
constexpr int PB = P - (TAPS - 1);      // 37: blurred (valid 7-tap)
constexpr int HALF_PATCH = 15;          // IC-angle circle radius
constexpr int HALF_OUT = (PB + 1) / 2;  // 19: first-pass rows per thread
constexpr int HALF_IN = HALF_OUT + TAPS - 1;   // 25: patch rows per thread
constexpr int SECOND = PB - HALF_OUT;   // 18: first output row of half 1
constexpr int THREADS = 96;             // 2 x 43 column halves, 3 warps
constexpr int WARPS = THREADS / 32;
constexpr int N_BINS = 32;
constexpr int N_BITS = 256;
constexpr int N_WORDS = N_BITS / 32;
constexpr int WORDS_PER_WARP = (N_WORDS + WARPS - 1) / WARPS;
// umax[0..15] of the radius-15 circle, 4 bits each (entry i at bits 4i):
// 15 15 15 15 14 14 14 13 13 12 11 10 9 8 6 3.
constexpr unsigned long long kUmax = 0x3689abcddeeeffffull;
// f32(2 pi) and f32(32 / 2 pi): the constants angles_from_moments adds and
// brief._angle_bins multiplies by.
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kBinScale = static_cast<float>(32.0 / (2.0 * 3.14159265358979323846));

static_assert(2 * P <= THREADS, "one thread per column half");
static_assert(SECOND + HALF_IN == P, "half 1 ends at the patch's last row");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Second (row-wise) pass at one output: sum_t rows[y][x + t] * k[t].
__device__ __forceinline__ float hblur(const float* rows, int x, int y,
                                       const float (&k)[TAPS]) {
  const float* src = rows + y * P + x;
  float acc = __fmul_rn(src[0], k[0]);
#pragma unroll
  for (int t = 1; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(src[t], k[t]));
  return acc;
}

template <bool kDescribe>
__global__ void __launch_bounds__(THREADS, 8)
gather_blur_moments_kernel(const float* __restrict__ canvas,
                           const int* __restrict__ xy,
                           const float* __restrict__ taps,
                           const signed char* __restrict__ table,
                           float* __restrict__ blurred,
                           float* __restrict__ moments,
                           float* __restrict__ angle,
                           int* __restrict__ desc, int N, int H, int W) {
  __shared__ float rows[PB * P];             // first pass: 37 rows x 43
  __shared__ float red[2][WARPS];
  const int kp = blockIdx.x;                 // flat (image, keypoint)
  const int b = kp / N;
  const int x0 = min(max(__ldg(xy + 2 * kp) - RADIUS, 0), W - P);
  const int y0 = min(max(__ldg(xy + 2 * kp + 1) - RADIUS, 0), H - P);
  float k[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) k[t] = __ldg(taps + t);

  const int tid = threadIdx.x;
  const int h = tid >= P;                    // which half of the rows
  const int c = tid - h * P;                 // patch column
  const int base = h * SECOND;               // first patch row held
  float m10 = 0.0f, m01 = 0.0f;
  if (tid < 2 * P) {
    const float* src = canvas + static_cast<size_t>(b) * H * W
                       + static_cast<size_t>(y0 + base) * W + x0 + c;
    float v[HALF_IN];
#pragma unroll
    for (int i = 0; i < HALF_IN; ++i) v[i] = __ldg(src + static_cast<size_t>(i) * W);

    // Moments: this column's rows of the circle, dy <= 0 in half 0 and
    // dy >= 1 in half 1.
    const int dx = c - RADIUS;
    const int adx = abs(dx);
    const int reach = adx <= HALF_PATCH
        ? static_cast<int>((kUmax >> (4 * adx)) & 0xfull) : -1;
    const int lo = max(RADIUS - reach, h ? RADIUS + 1 : 0) - base;
    const int hi = min(RADIUS + reach, h ? P - 1 : RADIUS) - base;
    const float fdx = static_cast<float>(dx);
#pragma unroll
    for (int i = 0; i < HALF_IN; ++i) {
      if (i >= lo && i <= hi) {
        m10 = __fadd_rn(m10, __fmul_rn(v[i], fdx));
        m01 = __fadd_rn(m01, __fmul_rn(v[i], static_cast<float>(base + i - RADIUS)));
      }
    }

    // First pass down the column: rows[base + r][c], r = 0..18; half 1
    // skips its row 18, which half 0 writes.
#pragma unroll
    for (int r = 0; r < HALF_OUT; ++r) {
      float acc = __fmul_rn(v[r], k[0]);
#pragma unroll
      for (int t = 1; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(v[r + t], k[t]));
      if (h == 0 || r > 0) rows[(base + r) * P + c] = acc;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(0xffffffffu, m10, off));
    m01 = __fadd_rn(m01, __shfl_xor_sync(0xffffffffu, m01, off));
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red[0][warp] = m10;
    red[1][warp] = m01;
  }
  __syncthreads();
  float s10 = red[0][0], s01 = red[1][0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    s10 = __fadd_rn(s10, red[0][w]);
    s01 = __fadd_rn(s01, red[1][w]);
  }
  if (tid == 0) {
    moments[2 * kp] = s10;
    moments[2 * kp + 1] = s01;
  }

  if constexpr (!kDescribe) {
    float* out = blurred + static_cast<size_t>(kp) * PB * PB;
    for (int i = tid; i < PB * PB; i += THREADS)
      out[i] = hblur(rows, i % PB, i / PB, k);
  } else {
    float a = atan2f(s01, s10);
    if (a < 0.0f) a = __fadd_rn(a, kTwoPi);
    if (tid == 0) angle[kp] = a;
    int bin = static_cast<int>(rintf(__fmul_rn(a, kBinScale)));
    bin = ((bin % N_BINS) + N_BINS) % N_BINS;
    // Warp w packs words w, w + WARPS, ...: all its table rows are loaded
    // before the first test.
    const char4* tab = reinterpret_cast<const char4*>(table) + bin * N_BITS;
    char4 q[WORDS_PER_WARP];                  // x1, y1, x2, y2
#pragma unroll
    for (int j = 0; j < WORDS_PER_WARP; ++j) {
      const int w = warp + j * WARPS;
      if (w < N_WORDS) q[j] = __ldg(tab + w * 32 + lane);
    }
#pragma unroll
    for (int j = 0; j < WORDS_PER_WARP; ++j) {
      const int w = warp + j * WARPS;
      if (w < N_WORDS) {
        const float v1 = bf16_round(hblur(rows, q[j].x, q[j].y, k));
        const float v2 = bf16_round(hblur(rows, q[j].z, q[j].w, k));
        const unsigned word = __ballot_sync(0xffffffffu, v2 > v1);
        if (lane == 0) desc[static_cast<size_t>(kp) * N_WORDS + w] = static_cast<int>(word);
      }
    }
  }
}

bool bad_shape(int B, int N, int H, int W, int radius) {
  return radius != RADIUS || H < P || W < P || B <= 0 || N < 0;
}

}  // namespace

extern "C" int orb_gather_blur_moments(const float* canvas, const int* xy,
                                       const float* taps, float* blurred,
                                       float* moments, int B, int N, int H,
                                       int W, int radius, cudaStream_t stream) {
  if (bad_shape(B, N, H, W, radius)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  gather_blur_moments_kernel<false><<<B * N, THREADS, 0, stream>>>(
      canvas, xy, taps, nullptr, blurred, moments, nullptr, nullptr, N, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int orb_gather_blur_describe(const float* canvas, const int* xy,
                                        const float* taps,
                                        const signed char* table,
                                        float* moments, float* angle, int* desc,
                                        int B, int N, int H, int W, int radius,
                                        cudaStream_t stream) {
  if (bad_shape(B, N, H, W, radius)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  gather_blur_moments_kernel<true><<<B * N, THREADS, 0, stream>>>(
      canvas, xy, taps, table, nullptr, moments, angle, desc, N, H, W);
  return static_cast<int>(cudaGetLastError());
}
