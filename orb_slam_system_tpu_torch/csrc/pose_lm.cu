// Kernel E: the motion-only pose LM (4 rounds x 10 Levenberg-Marquardt
// iterations on SE3, with chi2 reclassification between rounds) of one pose
// per thread block, every round in one launch.
//
// Replaces no TPU kernel: the JAX package's LM (solvers/pose_opt.py) is
// XLA. It was added because the eager torch loop of
// orb_slam_system_tpu_torch/solvers/pose_opt.py (`_lm`) is 10,644 small
// launches a pose, at 18-22 us of host time each, while the card's work per
// pose is a few microseconds. Contract: `_lm` in float32, the plain version
// beside the wrapper `pose_lm` in that module, to a tolerance (pose atol
// 1e-4, equal inlier masks): sums run in another order than the eager
// einsums, the 6x6 solve is this file's own LU, and Xc = R X + t is
// evaluated without multiply-add contraction (-fmad=false) where cuBLAS
// contracts.
//
// What bounds it on the card: neither bytes nor operations. An LM over
// 1,024 edges reads ~32 KB (0.01 us at 3.35 TB/s) and does ~10 MFLOP
// (~0.15 us at 67 TFLOP/s); it is one serial chain of 40 iterations, each a
// pass over the edges, a block-wide reduction of H (21 values), g (6) and
// the cost, a 6x6 solve, an SE3 exponential, a second pass for the trial
// cost and its reduction, then the accept decision. Its floor is the
// latency of that chain in one block: a few hundred microseconds.
//
// Design, against that latency:
//  * One block of 256 threads per pose (grid = the product of the leading
//    axes: 1 for pose_optimization, S for pose_optimization_batch).
//  * Thread t owns edges t, t + 256, ... in every pass, so an edge's data
//    and its flags (valid, inlier) are only ever touched by one thread. The
//    edges are read from device memory in every pass (28 B an edge, 28 KB
//    at N = 1,024, which L1 and L2 keep) and the flags live in the output
//    mask, so no N is refused. Staging the edges once in shared memory was
//    measured and dropped: 0.2240 / 0.2226 ms device an LM at 1,024 edges
//    against 0.2293 / 0.2292 read from device memory, 0.3351 / 0.3330
//    against 0.3493 / 0.3487 at 2,048, 0.2256 / 0.2240 against
//    0.2310 / 0.2314 for five poses of 1,024 (H100 80GB HBM3 at 700 W,
//    kernel_times.py, two runs each side in turns): 2.5-4.5% of the
//    kernel, ~11 us of a tracked frame's two LMs, for a second
//    instantiation and a shared-memory opt-in.
//  * Each pass accumulates the 28 sums in registers; the block reduces them
//    with a fixed tree (warp shuffles, then the warps' partials summed in
//    warp order by 28 threads): no atomics, so two runs are bit-equal.
//  * Thread 0 solves A dx = -g (A = H + lam diag(H) + 1e-9 I, LU with
//    partial pivoting as torch.linalg.solve_ex) and forms the trial pose
//    exp(xi + dx) T0 in one of two pose buffers; after the trial-cost
//    reduction every thread takes the same accept decision from the same
//    shared partials and swaps buffers on acceptance, so the accepted pose
//    is exp(xi) T0 with no recomputation (also the next round's T0).
//  * The SE3 exponential follows utils/lie._coeffs with its Taylor branch
//    at theta^2 <= 1e-8, with IEEE sinf / cosf / sqrtf and divisions.
//  * Four barriers an iteration; nothing allocated, nothing synchronised
//    with the host.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NACC = 28;              // H's upper triangle 21, g 6, cost 1

constexpr unsigned char VALID = 1;
constexpr unsigned char INLIER = 2;

struct Cam {
  float fx, fy, cx, cy, bf;
};

// The 95% chi2 gates and the Huber deltas, solvers/pose_opt.py's constants
// (CHI2_* and HUBER_DELTA_*), passed by the wrapper.
struct Gates {
  float chi2_mono, chi2_stereo, huber_mono, huber_stereo;
};

// One edge's projection at pose T (row-major 4x4; rows 0-2 read):
// e = [obs - pi(Xc); obs_ur - (u - bf / z) where stereo], as _residuals.
struct Residual {
  float x, y, z, inv_z, e0, e1, e2, chi2;
  bool stereo;
};

__device__ __forceinline__ Residual residual(const float* T, const float* X,
                                             const float* O, float ur,
                                             float isg, const Cam& c) {
  Residual r;
  r.x = T[0] * X[0] + T[1] * X[1] + T[2] * X[2] + T[3];
  r.y = T[4] * X[0] + T[5] * X[1] + T[6] * X[2] + T[7];
  r.z = T[8] * X[0] + T[9] * X[1] + T[10] * X[2] + T[11];
  const float zs = fabsf(r.z) < 1e-9f ? 1e-9f : r.z;
  r.inv_z = 1.0f / zs;
  const float u = c.fx * r.x * r.inv_z + c.cx;
  const float v = c.fy * r.y * r.inv_z + c.cy;
  r.stereo = ur >= 0.0f;
  r.e0 = O[0] - u;
  r.e1 = O[1] - v;
  r.e2 = r.stereo ? ur - (u - c.bf * r.inv_z) : 0.0f;
  r.chi2 = (r.e0 * r.e0 + r.e1 * r.e1 + r.e2 * r.e2) * isg;
  return r;
}

// _rho: Huber on chi2 in the first two rounds, chi2 itself after.
__device__ __forceinline__ float rho(float chi2, bool stereo, bool huber,
                                     const Gates& g) {
  if (!huber) return chi2;
  const float d = stereo ? g.huber_stereo : g.huber_mono;
  const float d2 = d * d;
  return chi2 > d2 ? 2.0f * d * sqrtf(fmaxf(chi2, 1e-12f)) - d2 : chi2;
}

// out = exp(xi) @ T0 (lie.se3_exp then a 4x4 product), xi = [rho, phi].
__device__ void se3_exp_mul(const float* xi, const float* T0, float* out) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + 1e-16f);
  const bool big = th2 > 1e-8f;
  const float t2s = big ? th2 : 1.0f;
  float A, B, C;
  if (big) {
    const float s = sinf(th), co = cosf(th);
    A = s / th;
    B = (1.0f - co) / t2s;
    C = (th - s) / (t2s * th);
  } else {
    A = 1.0f - th2 / 6.0f;
    B = 0.5f - th2 / 24.0f;
    C = static_cast<float>(1.0 / 6.0) - th2 / 120.0f;
  }
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float T[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float WW = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float I = i == j ? 1.0f : 0.0f;
      T[i][j] = I + A * W[i][j] + B * WW;
      V[j] = I + B * W[i][j] + C * WW;
    }
    T[i][3] = V[0] * xi[0] + V[1] * xi[1] + V[2] * xi[2];
  }
  T[3][0] = T[3][1] = T[3][2] = 0.0f;
  T[3][3] = 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[i * 4 + j] = T[i][0] * T0[j] + T[i][1] * T0[4 + j] +
                       T[i][2] * T0[8 + j] + T[i][3] * T0[12 + j];
}

// x = A^-1 b by LU with partial pivoting (the first largest |pivot|).
__device__ void solve6(float (&A)[6][6], float (&b)[6], float (&x)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float m = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > m) {
        m = fabsf(A[i][k]);
        p = i;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = b[k];
        b[k] = b[i];
        b[i] = t;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = A[i][j] - l * A[k][j];
      b[i] = b[i] - l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
pose_lm_kernel(const float* __restrict__ T0g, const float* __restrict__ Xw,
               const float* __restrict__ obs, const float* __restrict__ obs_ur,
               const float* __restrict__ inv_sigma2,
               const unsigned char* __restrict__ valid,
               float* __restrict__ T_out,
               unsigned char* __restrict__ inlier_out,
               long long* __restrict__ n_out,
               int N, int n_rounds, int n_iters, Cam cam, Gates gates) {
  __shared__ float pose[2][16];         // accepted / trial, swapped by `cur`
  __shared__ float base[16];            // the round's T0 (thread 0)
  __shared__ float part[WARPS][NACC];   // per-warp partial sums
  __shared__ float total[NACC];         // H upper, g, cost0
  __shared__ float part1[WARPS];        // per-warp trial-cost partials
  __shared__ int part_n[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const size_t e0 = b * static_cast<size_t>(N);

  const float* X = Xw + 3 * e0;
  const float* O = obs + 2 * e0;
  const float* U = obs_ur == nullptr ? nullptr : obs_ur + e0;
  const float* S = inv_sigma2 + e0;
  unsigned char* F = inlier_out + e0;   // this pose's flags, then its mask
  for (int i = tid; i < N; i += THREADS)
    F[i] = valid[e0 + i] ? (VALID | INLIER) : 0;
  if (tid < 16) {
    pose[0][tid] = T0g[b * 16 + tid];
    base[tid] = pose[0][tid];
  }
  __syncthreads();

  int cur = 0;
  float xi[6], xi_trial[6], lam = 0.0f;   // thread 0's LM state
  for (int r = 0; r < n_rounds; ++r) {
    const bool huber = r < 2;   // the reference drops the kernel after round 2
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) xi[k] = 0.0f;
      lam = 1e-4f;
      for (int k = 0; k < 16; ++k) base[k] = pose[cur][k];
    }
    for (int it = 0; it < n_iters; ++it) {
      // Pass 1: H, g and cost0 at the accepted pose.
      float acc[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
      const float* T = pose[cur];
      for (int i = tid; i < N; i += THREADS) {
        const float ur = U == nullptr ? -1.0f : U[i];
        const float isg = S[i];
        const Residual q = residual(T, X + 3 * i, O + 2 * i, ur, isg, cam);
        if (!((F[i] & INLIER) && q.z > 0.0f)) continue;
        float wh = 1.0f;
        if (huber) {
          const float d = q.stereo ? gates.huber_stereo : gates.huber_mono;
          wh = fminf(d / sqrtf(fmaxf(q.chi2, 1e-12f)), 1.0f);
        }
        const float w = wh * isg;
        const float iz2 = q.inv_z * q.inv_z;
        const float a = cam.fx * q.inv_z, bb = -cam.fx * q.x * iz2;
        const float c = cam.fy * q.inv_z, d = -cam.fy * q.y * iz2;
        const float f = (-cam.fx * q.x + cam.bf) * iz2;
        // J = -(J_proj [I | -hat(Xc)]); the third row only for stereo.
        const float J0[6] = {-a, 0.0f, -bb, -(bb * q.y),
                             -(a * q.z - bb * q.x), a * q.y};
        const float J1[6] = {0.0f, -c, -d, -(d * q.y - c * q.z), d * q.x,
                             -(c * q.x)};
        float J2[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (q.stereo) {
          J2[0] = -a;
          J2[2] = -f;
          J2[3] = -(f * q.y);
          J2[4] = -(a * q.z - f * q.x);
          J2[5] = a * q.y;
        }
        int k = 0;
#pragma unroll
        for (int m = 0; m < 6; ++m)
#pragma unroll
          for (int n = m; n < 6; ++n)
            acc[k++] += w * (J0[m] * J0[n] + J1[m] * J1[n] + J2[m] * J2[n]);
#pragma unroll
        for (int m = 0; m < 6; ++m)
          acc[21 + m] += w * (J0[m] * q.e0 + J1[m] * q.e1 + J2[m] * q.e2);
        acc[27] += rho(q.chi2, q.stereo, huber, gates);
      }
#pragma unroll
      for (int k = 0; k < NACC; ++k) {
        const float s = warp_sum(acc[k]);
        if (lane == 0) part[warp][k] = s;
      }
      __syncthreads();
      if (tid < NACC) {
        float s = part[0][tid];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += part[w][tid];
        total[tid] = s;
      }
      __syncthreads();
      // The step and the trial pose exp(xi + dx) T0.
      if (tid == 0) {
        float A[6][6], rhs[6], dx[6];
        int k = 0;
#pragma unroll
        for (int m = 0; m < 6; ++m)
#pragma unroll
          for (int n = m; n < 6; ++n) {
            A[m][n] = A[n][m] = total[k++];
          }
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          A[m][m] = A[m][m] + lam * A[m][m] + 1e-9f;
          rhs[m] = -total[21 + m];
        }
        solve6(A, rhs, dx);
#pragma unroll
        for (int m = 0; m < 6; ++m) xi_trial[m] = xi[m] + dx[m];
        se3_exp_mul(xi_trial, base, pose[cur ^ 1]);
      }
      __syncthreads();
      // Pass 2: cost1 at the trial pose, over inlier & z1 > 0.
      float c1 = 0.0f;
      const float* T1 = pose[cur ^ 1];
      for (int i = tid; i < N; i += THREADS) {
        if (!(F[i] & INLIER)) continue;
        const float ur = U == nullptr ? -1.0f : U[i];
        const Residual q = residual(T1, X + 3 * i, O + 2 * i, ur, S[i], cam);
        if (q.z > 0.0f) c1 += rho(q.chi2, q.stereo, huber, gates);
      }
      c1 = warp_sum(c1);
      if (lane == 0) part1[warp] = c1;
      __syncthreads();
      // Every thread takes the same decision from the same partials.
      float cost1 = part1[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) cost1 += part1[w];
      const bool improved = cost1 < total[27];
      if (improved) cur ^= 1;
      if (tid == 0) {
        if (improved) {
#pragma unroll
          for (int m = 0; m < 6; ++m) xi[m] = xi_trial[m];
        }
        lam = improved ? lam * 0.5f : lam * 4.0f;
        lam = fminf(fmaxf(lam, 1e-10f), 1e6f);
      }
    }
    // Reclassify at T0 = exp(xi) T0 (the accepted pose): raw chi2 against
    // the 95% gates.
    const float* T = pose[cur];
    for (int i = tid; i < N; i += THREADS) {
      const float ur = U == nullptr ? -1.0f : U[i];
      const Residual q = residual(T, X + 3 * i, O + 2 * i, ur, S[i], cam);
      const float gate = q.stereo ? gates.chi2_stereo : gates.chi2_mono;
      const bool in = (F[i] & VALID) && q.z > 0.0f && q.chi2 <= gate;
      F[i] = (F[i] & VALID) | (in ? INLIER : 0);
    }
  }

  int n = 0;
  for (int i = tid; i < N; i += THREADS) {
    const bool in = F[i] & INLIER;
    F[i] = in ? 1 : 0;
    n += in ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if (lane == 0) part_n[warp] = n;
  __syncthreads();
  if (tid == 0) {
    long long total_n = 0;
    for (int w = 0; w < WARPS; ++w) total_n += part_n[w];
    n_out[b] = total_n;
  }
  if (tid < 16) T_out[b * 16 + tid] = pose[cur][tid];
}

}  // namespace

// B poses of N edges each, every array contiguous with the pose axis
// first; obs_ur may be null (every edge monocular).
extern "C" int orb_pose_lm(const float* T0, const float* Xw, const float* obs,
                           const float* obs_ur, const float* inv_sigma2,
                           const unsigned char* valid, float* T_out,
                           unsigned char* inlier_out,
                           long long* n_out, int B, int N, int n_rounds,
                           int n_iters, float fx, float fy, float cx, float cy,
                           float bf, float chi2_mono, float chi2_stereo,
                           float huber_mono, float huber_stereo,
                           cudaStream_t stream) {
  if (B < 0 || N < 0 || n_rounds < 0 || n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Cam cam{fx, fy, cx, cy, bf};
  const Gates gates{chi2_mono, chi2_stereo, huber_mono, huber_stereo};
  pose_lm_kernel<<<B, THREADS, 0, stream>>>(
      T0, Xw, obs, obs_ur, inv_sigma2, valid, T_out, inlier_out, n_out, N,
      n_rounds, n_iters, cam, gates);
  return static_cast<int>(cudaGetLastError());
}
