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
// iteration is ~150 KFLOP, but the 11 iterations depend on each other and
// each ends in a 27-sum reduction and a scalar 6x6 solve. The design keeps
// the chain in one block and shortens each link:
//   - each thread stages its own rows once in shared memory (up to
//     kMaxStaged in all, padded to a whole number of rows per thread with
//     rows of weight 0; no barrier, as no other thread reads them), their
//     valid and inlier flags in per-thread bit masks; inside the iteration
//     loop nothing touches device memory. Rows past kMaxStaged stream from
//     device memory, their flags in the inlier output;
//   - 256 threads, each evaluating its rows 4 at a time, so that the rows'
//     divisions and square roots overlap (the main path's 1024 rows are one
//     group per thread);
//   - the 27 sums are reduced in a fixed order: each thread sums its own
//     rows, a warp reduce-scatter (31 shuffles: after 5 halving steps lane
//     c holds column c), then lane c of warp 0 adds column c of the warp
//     partials in warp order;
//   - warp 0 alone solves and composes, while the other warps wait at the
//     barrier: a solve repeated by every warp costs issue slots that the
//     one on the critical path needs. The solve is the floored Cholesky in
//     its square-root-free LDL^T form, one IEEE reciprocal per diagonal in
//     place of 6 square roots and 27 divisions, then one sincosf and one
//     reciprocal of theta for the se3 factors; the new pose goes to every
//     thread through shared memory (two __syncthreads per iteration).
// What is left (chip_smoke.py prints the phases of the -DPOSE_GN_PROFILE
// build): at 1024 rows the row evaluation takes more than half of the
// chain, one SM issuing 4 rows for each of 256 threads; then the serial
// solve and compose of warp 0, then the reduction.
// Built without --use_fast_math: sqrtf, sincosf and division stay
// IEEE-accurate.

#include <cuda_runtime.h>

// phases of the chain, for -DPOSE_GN_PROFILE
enum Phase { kStage, kRows, kReduce, kBarrier1, kColumnSums, kSolve, kCompose,
             kBarrier2, kFinal, kPhases };

// Built with -DPOSE_GN_PROFILE (orb_slam_tpu_torch/profile_kernels.py),
// thread 0 adds the clock64() cycles of each phase of the chain to
// g_phase_cycles, read by pose_gn_phase_cycles; without it the markers are
// empty.
#ifdef POSE_GN_PROFILE
__device__ unsigned long long g_phase_cycles[kPhases];
#define PHASE(i)                                  \
  {                                               \
    const long long t_ = clock64();               \
    phase_[i] += t_ - tick_;                      \
    tick_ = t_;                                   \
  }
#else
#define PHASE(i)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;          // H upper triangle (21) + b (6)
constexpr int kMaxStaged = 4096;   // p_local's default, the tracker's largest N
constexpr int kRowsPerThread = kMaxStaged / kThreads;
constexpr int kStageFields = 6;    // x, y, z, u, v, 1/sigma^2
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kMaxStaged % kThreads == 0, "block shape");
static_assert(kRowsPerThread <= 32, "one flag bit per staged row");
__constant__ float kChi2[4] = {9.21f, 7.378f, 5.991f, 5.991f};

struct Pose {
  float R[3][3];
  float t[3];
};

struct Cam {
  float fx, fy, cx, cy;
};

// Residual, chi2 and depth sign of one row; with `jac`, the 7 entries of
// [J|r] for u and v (left-multiplied se3, as _residuals_jac).
struct Row {
  float chi2, zpos;
  float au[7], av[7];
};

template <bool kJac>
__device__ __forceinline__ Row eval_row(const Pose& P, const Cam& K, float px,
                                        float py, float pz, float ou, float ov,
                                        float is2) {
  Row r;
  const float x = P.R[0][0] * px + P.R[0][1] * py + P.R[0][2] * pz + P.t[0];
  const float y = P.R[1][0] * px + P.R[1][1] * py + P.R[1][2] * pz + P.t[1];
  const float zc = P.R[2][0] * px + P.R[2][1] * py + P.R[2][2] * pz + P.t[2];
  const float zs = fabsf(zc) < 1e-9f ? 1e-9f : zc;
  const float iz = 1.0f / zs;
  const float ru = K.fx * x * iz + K.cx - ou;
  const float rv = K.fy * y * iz + K.cy - ov;
  r.chi2 = (ru * ru + rv * rv) * is2;
  r.zpos = zc > 0.0f ? 1.0f : 0.0f;
  if (kJac) {
    const float iz2 = iz * iz;
    const float du0 = K.fx * iz, du2 = -K.fx * x * iz2;
    const float dv1 = K.fy * iz, dv2 = -K.fy * y * iz2;
    const float hu0 = du2 * (-y), hu1 = du0 * (-zc) + du2 * x, hu2 = du0 * y;
    const float hv0 = dv1 * zc + dv2 * (-y), hv1 = dv2 * x, hv2 = dv1 * (-x);
    r.au[0] = du0; r.au[1] = 0.0f; r.au[2] = du2;
    r.au[3] = -hu0; r.au[4] = -hu1; r.au[5] = -hu2; r.au[6] = ru;
    r.av[0] = 0.0f; r.av[1] = dv1; r.av[2] = dv2;
    r.av[3] = -hv0; r.av[4] = -hv1; r.av[5] = -hv2; r.av[6] = rv;
  }
  return r;
}

// Index of entry (i, j), i <= j < 7, in the 27 sums: row-major over the
// upper triangle of [J|r]^T W [J|r] without (6, 6).
__host__ __device__ constexpr int sum_index(int i, int j) {
  return 7 * i - i * (i - 1) / 2 + (j - i);
}

// The IRLS step of G rows at once (G independent chains, so the rows'
// divisions and square roots overlap): re-gate each row's inlier flag on
// the round's first pass, then add its weighted [J|r]^T [J|r] to acc.
template <int G>
__device__ __forceinline__ void add_rows(const Pose& P, const Cam& K,
                                         const float (&px)[G], const float (&py)[G],
                                         const float (&pz)[G], const float (&ou)[G],
                                         const float (&ov)[G], const float (&is2)[G],
                                         const bool (&valid)[G], float gate,
                                         bool (&inlier)[G], float (&acc)[32]) {
  const float delta = static_cast<float>(2.4476519360399265);  // sqrt(5.991)
  Row r[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    r[g] = eval_row<true>(P, K, px[g], py[g], pz[g], ou[g], ov[g], is2[g]);
  float w[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (gate >= 0.0f) inlier[g] = valid[g] && r[g].zpos > 0.0f && r[g].chi2 <= gate;
    const float e = sqrtf(fmaxf(r[g].chi2, 1e-12f));
    const float wh = e <= delta ? 1.0f : delta / e;
    w[g] = is2[g] * wh * (inlier[g] ? 1.0f : 0.0f) * r[g].zpos;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float wu = w[g] * r[g].au[i], wv = w[g] * r[g].av[i];
#pragma unroll
      for (int j = i; j < 7; ++j)
        acc[sum_index(i, j)] += wu * r[g].au[j] + wv * r[g].av[j];
    }
  }
}

// add_rows on the G staged rows tid + (k0 + g) kThreads, g < G; their
// flags are bits k0 .. k0 + G - 1 of the masks
template <int G>
__device__ __forceinline__ void add_staged(const Pose& P, const Cam& K,
                                           const float* stage, int n_staged,
                                           int tid, int k0, unsigned vmask,
                                           float gate, unsigned& imask,
                                           float (&acc)[32]) {
  float f[kStageFields][G];
  bool valid[G], in[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int n = tid + (k0 + g) * kThreads;
#pragma unroll
    for (int q = 0; q < kStageFields; ++q) f[q][g] = stage[q * n_staged + n];
    valid[g] = (vmask >> (k0 + g)) & 1u;
    in[g] = (imask >> (k0 + g)) & 1u;
  }
  add_rows<G>(P, K, f[0], f[1], f[2], f[3], f[4], f[5], valid, gate, in, acc);
#pragma unroll
  for (int g = 0; g < G; ++g)
    imask = (imask & ~(1u << (k0 + g))) | (static_cast<unsigned>(in[g]) << (k0 + g));
}

// One halving step of the warp reduce-scatter: lanes with bit kHalf set
// keep columns [kHalf, 2 kHalf) of their current range, the others
// [0, kHalf), each adding its partner's copy.
template <int kHalf>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kHalf);
  }
}

// dx = (H + damping I)^-1 rhs, H and rhs = -b from the 27 sums S: the
// Cholesky with the 1e-12 floor of pose_opt_pallas._chol_solve6 in its
// square-root-free form H = L D L^T (L unit lower, d_j = L'_jj^2 of the
// Cholesky factor L' = L D^1/2, so the floor reads d_j = max(s_j, 1e-12)),
// one reciprocal per diagonal and no square root.
__device__ __forceinline__ void chol_solve6(const float (&S)[kSums], float damping,
                                            float (&dx)[6]) {
  float L[6][6], LD[6][6], dinv[6], z[6];  // LD[i][m] = L[i][m] d[m]
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = S[sum_index(j, j)] + damping;
#pragma unroll
    for (int m = 0; m < j; ++m) d = d - L[j][m] * LD[j][m];
    dinv[j] = 1.0f / fmaxf(d, 1e-12f);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = S[sum_index(j, i)];
#pragma unroll
      for (int m = 0; m < j; ++m) s = s - L[i][m] * LD[j][m];
      LD[i][j] = s;
      L[i][j] = s * dinv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = -S[sum_index(i, 6)];
#pragma unroll
    for (int m = 0; m < i; ++m) s = s - L[i][m] * z[m];
    z[i] = s;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = z[i] * dinv[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s = s - L[m][i] * dx[m];
    dx[i] = s;
  }
}

// (R, t) <- exp(dx) o (R, t), dx = [rho, phi] (pose_opt_pallas.py:69-94).
__device__ __forceinline__ void se3_exp_compose(const float (&dx)[6], Pose& P) {
  const float rho[3] = {dx[0], dx[1], dx[2]};
  const float phi[3] = {dx[3], dx[4], dx[5]};
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(fmaxf(th2, 1e-24f));
  const bool small = th2 < 1e-12f;
  float sn, cs;
  sincosf(th, &sn, &cs);
  // one reciprocal in place of the three divisions sin th / th,
  // (1 - cos th) / th^2 and (th - sin th) / th^3; off the small-angle
  // branch th >= 1e-6, so the floors of those divisions never bind
  const float ith = 1.0f / th, ith2 = ith * ith;
  const float A = small ? 1.0f - th2 / 6.0f : sn * ith;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - cs) * ith2;
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f : (th - sn) * (ith2 * ith);
  const float Ph[3][3] = {{0.0f, -phi[2], phi[1]},
                          {phi[2], 0.0f, -phi[0]},
                          {-phi[1], phi[0], 0.0f}};
  float Ph2[3][3], Re[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Ph2[i][j] = Ph[i][0] * Ph[0][j] + Ph[i][1] * Ph[1][j] + Ph[i][2] * Ph[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.0f : 0.0f;
      Re[i][j] = I + A * Ph[i][j] + B * Ph2[i][j];
      V[i][j] = I + B * Ph[i][j] + C * Ph2[i][j];
    }
  Pose out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float te = V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.R[i][j] = Re[i][0] * P.R[0][j] + Re[i][1] * P.R[1][j] + Re[i][2] * P.R[2][j];
    out.t[i] = Re[i][0] * P.t[0] + Re[i][1] * P.t[1] + Re[i][2] * P.t[2] + te;
  }
  P = out;
}

__global__ void __launch_bounds__(kThreads)
pose_gn_kernel(const float* __restrict__ T0, const float* __restrict__ Kmat,
               const float* __restrict__ pts, const float* __restrict__ uv,
               const float* __restrict__ inv_sigma2,
               const bool* __restrict__ valid, float* __restrict__ T_out,
               bool* __restrict__ inlier, int* __restrict__ n_inliers, int N,
               int n_staged, int it0, int it1, int it2, int it3, float damping) {
  // stage[f * n_staged + n]: field f of staged row n; n_staged is N (at
  // most kMaxStaged) rounded up to a multiple of kThreads
  extern __shared__ float stage[];
  __shared__ float partial[kWarps][32];
  __shared__ __align__(16) float sums[32];
  __shared__ Pose pose;
  __shared__ int count[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#ifdef POSE_GN_PROFILE
  long long tick_ = clock64(), phase_[kPhases] = {};
#endif
  const int iters[4] = {it0, it1, it2, it3};
  const int n_real = min(N, n_staged);  // staged rows that hold data
  const int rows_here = n_staged / kThreads;

  // stage this thread's rows tid + k kThreads (only this thread reads
  // them, so no barrier), 4 rows' loads issued before their stores;
  // padding rows have weight 0 (1/sigma^2 = 0, not valid)
  unsigned vmask = 0;  // bit k: row tid + k * kThreads is valid
  for (int k0 = 0; k0 < rows_here; k0 += 4) {
    float f[kStageFields][4];
    bool vd[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int n = tid + (k0 + g) * kThreads;
      const bool real = n < n_real;
      f[0][g] = real ? pts[3 * n] : 0.0f;
      f[1][g] = real ? pts[3 * n + 1] : 0.0f;
      f[2][g] = real ? pts[3 * n + 2] : 1.0f;
      f[3][g] = real ? uv[2 * n] : 0.0f;
      f[4][g] = real ? uv[2 * n + 1] : 0.0f;
      f[5][g] = real ? inv_sigma2[n] : 0.0f;
      vd[g] = real && valid[n];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (k0 + g >= rows_here) break;
      const int n = tid + (k0 + g) * kThreads;
#pragma unroll
      for (int q = 0; q < kStageFields; ++q) stage[q * n_staged + n] = f[q][g];
      vmask |= static_cast<unsigned>(vd[g]) << (k0 + g);
    }
  }
  unsigned imask = vmask;  // inlier flags of the staged rows
  for (int n = n_staged + tid; n < N; n += kThreads) inlier[n] = valid[n];

  Pose P;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P.R[i][j] = T0[4 * i + j];
    P.t[i] = T0[4 * i + 3];
  }
  const Cam K{Kmat[0], Kmat[4], Kmat[2], Kmat[5]};
  PHASE(kStage);

  float pending = -1.0f;  // chi2 gate owed by the next round's first pass
  for (int rnd = 0; rnd < 4; ++rnd) {
    for (int it = 0; it < iters[rnd]; ++it) {
      const float gate = it == 0 ? pending : -1.0f;
      float acc[32];
#pragma unroll
      for (int s = 0; s < 32; ++s) acc[s] = 0.0f;
      int k = 0;
      for (; k + 4 <= rows_here; k += 4)
        add_staged<4>(P, K, stage, n_staged, tid, k, vmask, gate, imask, acc);
      for (; k < rows_here; ++k)
        add_staged<1>(P, K, stage, n_staged, tid, k, vmask, gate, imask, acc);
      for (int n = n_staged + tid; n < N; n += kThreads) {
        const float px[1] = {pts[3 * n]}, py[1] = {pts[3 * n + 1]};
        const float pz[1] = {pts[3 * n + 2]}, ou[1] = {uv[2 * n]};
        const float ov[1] = {uv[2 * n + 1]}, is2[1] = {inv_sigma2[n]};
        const bool vd[1] = {valid[n]};
        bool in[1] = {inlier[n]};
        add_rows<1>(P, K, px, py, pz, ou, ov, is2, vd, gate, in, acc);
        if (gate >= 0.0f) inlier[n] = in[0];
      }

      PHASE(kRows);
      // warp reduce-scatter: lane c ends with the warp's sum of column c
      halve<16>(acc, lane);
      halve<8>(acc, lane);
      halve<4>(acc, lane);
      halve<2>(acc, lane);
      halve<1>(acc, lane);
      PHASE(kReduce);
      partial[warp][lane] = acc[0];
      __syncthreads();
      PHASE(kBarrier1);

      // warp 0 alone: lane c adds column c of the warp partials, then every
      // lane reads the 27 sums, solves and composes (the other warps wait
      // at the barrier and take no issue slots from it)
      if (warp == 0) {
        float col = partial[0][lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) col += partial[w][lane];
        sums[lane] = col;
        __syncwarp();
        float S[kSums];
#pragma unroll
        for (int q = 0; q < 7; ++q) {
          const float4 v = reinterpret_cast<const float4*>(sums)[q];
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4 * q + c < kSums) S[4 * q + c] = e[c];
        }
        PHASE(kColumnSums);
        float dx[6];
        chol_solve6(S, damping, dx);
        float fin = dx[0];
#pragma unroll
        for (int i = 1; i < 6; ++i) fin = fin + dx[i];
        if (!isfinite(fin)) {
#pragma unroll
          for (int i = 0; i < 6; ++i) dx[i] = 0.0f;
        }
        PHASE(kSolve);
        se3_exp_compose(dx, P);
        if (lane == 0) pose = P;
        PHASE(kCompose);
      }
      __syncthreads();
      PHASE(kBarrier2);
      P = pose;
    }
    pending = kChi2[rnd];
  }

  // final gate on the last pose (before orthonormalization, as the kernel
  // it replaces)
  int mine = 0;
  for (int k = 0; k < rows_here; ++k) {
    const int n = tid + k * kThreads;
    if (n >= n_real) break;
    const float* f = stage + n;
    const Row r = eval_row<false>(P, K, f[0], f[n_staged], f[2 * n_staged],
                                  f[3 * n_staged], f[4 * n_staged], f[5 * n_staged]);
    const bool in = ((vmask >> k) & 1u) && r.zpos > 0.0f && r.chi2 <= kChi2[3];
    inlier[n] = in;
    mine += in ? 1 : 0;
  }
  for (int n = n_staged + tid; n < N; n += kThreads) {
    const Row r = eval_row<false>(P, K, pts[3 * n], pts[3 * n + 1], pts[3 * n + 2],
                                  uv[2 * n], uv[2 * n + 1], inv_sigma2[n]);
    const bool in = valid[n] && r.zpos > 0.0f && r.chi2 <= kChi2[3];
    inlier[n] = in;
    mine += in ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mine += __shfl_down_sync(kFull, mine, off);
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
    PHASE(kFinal);
#ifdef POSE_GN_PROFILE
    for (int i = 0; i < kPhases; ++i) g_phase_cycles[i] += phase_[i];
#endif
  }
}

}  // namespace

extern "C" int pose_gn(const void* T0, const void* K, const void* pts,
                       const void* uv, const void* inv_sigma2, const void* valid,
                       void* T_out, void* inlier, void* n_inliers, int N, int it0,
                       int it1, int it2, int it3, float damping, void* stream) {
  if (N < 1 || it0 < 0 || it1 < 0 || it2 < 0 || it3 < 0) return cudaErrorInvalidValue;
  const int staged = N < kMaxStaged ? N : kMaxStaged;
  const int n_staged = (staged + kThreads - 1) / kThreads * kThreads;
  const int smem = kStageFields * n_staged * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      pose_gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pose_gn_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T0), static_cast<const float*>(K),
      static_cast<const float*>(pts), static_cast<const float*>(uv),
      static_cast<const float*>(inv_sigma2), static_cast<const bool*>(valid),
      static_cast<float*>(T_out), static_cast<bool*>(inlier),
      static_cast<int*>(n_inliers), N, n_staged, it0, it1, it2, it3, damping);
  return static_cast<int>(cudaGetLastError());
}

#ifdef POSE_GN_PROFILE
// Copies the phase cycle sums to host memory `out` (kPhases uint64) and
// zeroes them.
extern "C" int pose_gn_phase_cycles(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
}
#endif

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
