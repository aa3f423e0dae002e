// Kernel K2: the whole pose-only Gauss-Newton chain in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orb_slam_tpu/solvers/pose_opt_pallas.py:
// _make_pose_gn_kernel (entry pose_optimize_pallas), which the main path
// reaches through pose_opt.py:177-180 from track_kernels.py:178.
//
// What it computes (Optimizer::PoseOptimization, src/Optimizer.cc:154-285):
// 4 rounds of iters[r] damped GN iterations; round r > 0 re-gates the edges
// on its first residual pass with the previous round's chi2 threshold
// (9.21 / 7.378 / 5.991 / 5.991). Each iteration weighs the rows with Huber
// IRLS weights on the sigma-normalized error, sums the 27 distinct entries
// of the normal equations [J|r]^T W [J|r] (21 of the upper 6x6 H, 6 of b),
// solves (H + damping I) dx = -b by an unrolled Cholesky with the 1e-12
// floor, zeroes a non-finite step, and composes T <- exp(dx) T. A final
// chi2 gate at 5.991 gives the inliers; Gram-Schmidt re-orthonormalizes R.
// The formulas are those of the Pallas kernel (small-angle guard
// th^2 < 1e-12, C = (th - sin th) / th^3), not those of geometry/se3.py.
//
// What bounds it on the H100: latency. At the main path's 1024 rows an
// iteration is ~60 KFLOP, but the 11 iterations depend on each other and
// each ends in a scalar 6x6 solve. The design keeps the whole chain in one
// block of 256 threads: each thread strides over rows with the pose in
// shared memory, the 27 sums are reduced in a fixed order (warp shuffles,
// then the 8 warp partials in shared memory, summed by thread 0), thread 0
// solves and composes, and the new pose is broadcast through shared
// memory. One launch per frame; nothing round-trips through the host.
// Built without --use_fast_math: sinf, cosf, sqrtf and division stay
// IEEE-accurate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // H upper triangle (21) + b (6)
__constant__ float kChi2[4] = {9.21f, 7.378f, 5.991f, 5.991f};

struct Pose {
  float R[3][3];
  float t[3];
};

// Residual, chi2 and depth sign of one row; with `jac`, the 7 entries of
// [J|r] for u and v (left-multiplied se3, as _residuals_jac).
struct Row {
  float chi2, zpos;
  float au[7], av[7];
};

template <bool kJac>
__device__ __forceinline__ Row eval_row(const Pose& P, const float* K, float px,
                                        float py, float pz, float ou, float ov,
                                        float is2) {
  const float fx = K[0], fy = K[4], cx = K[2], cy = K[5];
  Row r;
  const float x = P.R[0][0] * px + P.R[0][1] * py + P.R[0][2] * pz + P.t[0];
  const float y = P.R[1][0] * px + P.R[1][1] * py + P.R[1][2] * pz + P.t[1];
  const float zc = P.R[2][0] * px + P.R[2][1] * py + P.R[2][2] * pz + P.t[2];
  const float zs = fabsf(zc) < 1e-9f ? 1e-9f : zc;
  const float iz = 1.0f / zs;
  const float ru = fx * x * iz + cx - ou;
  const float rv = fy * y * iz + cy - ov;
  r.chi2 = (ru * ru + rv * rv) * is2;
  r.zpos = zc > 0.0f ? 1.0f : 0.0f;
  if (kJac) {
    const float iz2 = iz * iz;
    const float du0 = fx * iz, du2 = -fx * x * iz2;
    const float dv1 = fy * iz, dv2 = -fy * y * iz2;
    const float hu0 = du2 * (-y), hu1 = du0 * (-zc) + du2 * x, hu2 = du0 * y;
    const float hv0 = dv1 * zc + dv2 * (-y), hv1 = dv2 * x, hv2 = dv1 * (-x);
    r.au[0] = du0; r.au[1] = 0.0f; r.au[2] = du2;
    r.au[3] = -hu0; r.au[4] = -hu1; r.au[5] = -hu2; r.au[6] = ru;
    r.av[0] = 0.0f; r.av[1] = dv1; r.av[2] = dv2;
    r.av[3] = -hv0; r.av[4] = -hv1; r.av[5] = -hv2; r.av[6] = rv;
  }
  return r;
}

// dx = (H + damping I)^-1 rhs with H from the 21 upper entries S (row-major
// over i <= j); the operation order of pose_opt_pallas._chol_solve6.
__device__ void chol_solve6(const float* S, const float* rhs, float damping,
                            float* dx) {
  float H[6][6];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) H[i][j] = H[j][i] = S[k++];
  for (int i = 0; i < 6; ++i) H[i][i] = H[i][i] + damping;
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[i][j];
      for (int m = 0; m < j; ++m) s = s - L[i][m] * L[j][m];
      L[i][j] = i == j ? sqrtf(fmaxf(s, 1e-12f)) : s / L[j][j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
    for (int m = 0; m < i; ++m) s = s - L[i][m] * y[m];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int m = i + 1; m < 6; ++m) s = s - L[m][i] * dx[m];
    dx[i] = s / L[i][i];
  }
}

// (R, t) <- exp(dx) o (R, t), dx = [rho, phi] (pose_opt_pallas.py:69-94).
__device__ void se3_exp_compose(const float* dx, Pose& P) {
  const float* rho = dx;
  const float* phi = dx + 3;
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(fmaxf(th2, 1e-24f));
  const bool small = th2 < 1e-12f;
  const float A = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / fmaxf(th2, 1e-24f);
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f
                        : (th - sinf(th)) / fmaxf(th2 * th, 1e-36f);
  const float Ph[3][3] = {{0.0f, -phi[2], phi[1]},
                          {phi[2], 0.0f, -phi[0]},
                          {-phi[1], phi[0], 0.0f}};
  float Ph2[3][3], Re[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Ph2[i][j] = Ph[i][0] * Ph[0][j] + Ph[i][1] * Ph[1][j] + Ph[i][2] * Ph[2][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.0f : 0.0f;
      Re[i][j] = I + A * Ph[i][j] + B * Ph2[i][j];
      V[i][j] = I + B * Ph[i][j] + C * Ph2[i][j];
    }
  Pose out;
  for (int i = 0; i < 3; ++i) {
    const float te = V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2];
    for (int j = 0; j < 3; ++j)
      out.R[i][j] = Re[i][0] * P.R[0][j] + Re[i][1] * P.R[1][j] + Re[i][2] * P.R[2][j];
    out.t[i] = Re[i][0] * P.t[0] + Re[i][1] * P.t[1] + Re[i][2] * P.t[2] + te;
  }
  P = out;
}

__global__ void __launch_bounds__(kThreads)
pose_gn_kernel(const float* __restrict__ T0, const float* __restrict__ K,
               const float* __restrict__ pts, const float* __restrict__ uv,
               const float* __restrict__ inv_sigma2,
               const bool* __restrict__ valid, float* __restrict__ T_out,
               bool* __restrict__ inlier, int* __restrict__ n_inliers, int N,
               int it0, int it1, int it2, int it3, float damping) {
  __shared__ Pose pose;
  __shared__ float partial[kWarps][kSums];
  __shared__ int count[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int iters[4] = {it0, it1, it2, it3};
  const float delta = static_cast<float>(2.4476519360399265);  // sqrt(5.991)

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) pose.R[i][j] = T0[4 * i + j];
      pose.t[i] = T0[4 * i + 3];
    }
  }
  for (int n = tid; n < N; n += kThreads) inlier[n] = valid[n];
  __syncthreads();

  float pending = -1.0f;  // chi2 gate owed by the next round's first pass
  for (int rnd = 0; rnd < 4; ++rnd) {
    for (int it = 0; it < iters[rnd]; ++it) {
      const Pose P = pose;
      float acc[kSums];
#pragma unroll
      for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;
      for (int n = tid; n < N; n += kThreads) {
        const Row r = eval_row<true>(P, K, pts[3 * n], pts[3 * n + 1],
                                     pts[3 * n + 2], uv[2 * n], uv[2 * n + 1],
                                     inv_sigma2[n]);
        if (it == 0 && pending >= 0.0f)
          inlier[n] = valid[n] && r.zpos > 0.0f && r.chi2 <= pending;
        const float e = sqrtf(fmaxf(r.chi2, 1e-12f));
        const float wh = e <= delta ? 1.0f : delta / e;
        const float w = inv_sigma2[n] * wh * (inlier[n] ? 1.0f : 0.0f) * r.zpos;
        int s = 0;
#pragma unroll
        for (int i = 0; i < 7; ++i) {
          const float wu = w * r.au[i], wv = w * r.av[i];
#pragma unroll
          for (int j = i; j < 7; ++j) {
            if (i == 6) continue;  // r.r is not needed
            acc[s++] += wu * r.au[j] + wv * r.av[j];
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSums; ++s) {
        float v = acc[s];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) partial[warp][s] = v;
      }
      __syncthreads();
      if (tid == 0) {
        float S[kSums];
        for (int s = 0; s < kSums; ++s) {
          float v = partial[0][s];
          for (int w = 1; w < kWarps; ++w) v += partial[w][s];
          S[s] = v;
        }
        // S is row-major over i <= j < 7 without (6, 6): H(i, j) for j < 6
        // and b(i) = S(i, 6)
        float Hu[21], rhs[6], dx[6];
        int s = 0, h = 0;
        for (int i = 0; i < 6; ++i) {
          for (int j = i; j < 6; ++j) Hu[h++] = S[s++];
          rhs[i] = -S[s++];
        }
        chol_solve6(Hu, rhs, damping, dx);
        float fin = dx[0];
        for (int i = 1; i < 6; ++i) fin = fin + dx[i];
        if (!isfinite(fin))
          for (int i = 0; i < 6; ++i) dx[i] = 0.0f;
        Pose Pn = pose;
        se3_exp_compose(dx, Pn);
        pose = Pn;
      }
      __syncthreads();
    }
    pending = kChi2[rnd];
  }

  // final gate on the last pose (before orthonormalization, as the kernel
  // it replaces)
  const Pose P = pose;
  int mine = 0;
  for (int n = tid; n < N; n += kThreads) {
    const Row r = eval_row<false>(P, K, pts[3 * n], pts[3 * n + 1],
                                  pts[3 * n + 2], uv[2 * n], uv[2 * n + 1],
                                  inv_sigma2[n]);
    const bool in = valid[n] && r.zpos > 0.0f && r.chi2 <= kChi2[3];
    inlier[n] = in;
    mine += in ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, off);
  if (lane == 0) count[warp] = mine;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += count[w];
    *n_inliers = total;
    // Gram-Schmidt on the columns of R
    float c0[3], c1[3], c2[3];
    for (int i = 0; i < 3; ++i) { c0[i] = P.R[i][0]; c1[i] = P.R[i][1]; }
    const float n0 = sqrtf(c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2]);
    for (int i = 0; i < 3; ++i) c0[i] = c0[i] / n0;
    const float d = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
    for (int i = 0; i < 3; ++i) c1[i] = c1[i] - d * c0[i];
    const float n1 = sqrtf(c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2]);
    for (int i = 0; i < 3; ++i) c1[i] = c1[i] / n1;
    c2[0] = c0[1] * c1[2] - c0[2] * c1[1];
    c2[1] = c0[2] * c1[0] - c0[0] * c1[2];
    c2[2] = c0[0] * c1[1] - c0[1] * c1[0];
    for (int i = 0; i < 3; ++i) {
      T_out[4 * i + 0] = c0[i];
      T_out[4 * i + 1] = c1[i];
      T_out[4 * i + 2] = c2[i];
      T_out[4 * i + 3] = P.t[i];
    }
    T_out[12] = 0.0f; T_out[13] = 0.0f; T_out[14] = 0.0f; T_out[15] = 1.0f;
  }
}

}  // namespace

extern "C" int pose_gn(const void* T0, const void* K, const void* pts,
                       const void* uv, const void* inv_sigma2, const void* valid,
                       void* T_out, void* inlier, void* n_inliers, int N, int it0,
                       int it1, int it2, int it3, float damping, void* stream) {
  if (N < 1 || it0 < 0 || it1 < 0 || it2 < 0 || it3 < 0) return cudaErrorInvalidValue;
  pose_gn_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T0), static_cast<const float*>(K),
      static_cast<const float*>(pts), static_cast<const float*>(uv),
      static_cast<const float*>(inv_sigma2), static_cast<const bool*>(valid),
      static_cast<float*>(T_out), static_cast<bool*>(inlier),
      static_cast<int*>(n_inliers), N, it0, it1, it2, it3, damping);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
