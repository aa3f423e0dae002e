// Kernel K3: FAST-9/16 score and 3x3 non-maximum suppression over the whole
// [L, H, W] canvas, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orb_slam_tpu/ops/pallas_fast.py:
// _make_fast_kernel (entry fast_score_nms_pallas, :63-85), whose NMS is the
// XLA reduce_window that follows it. The XLA stacked detector
// (orb_slam_tpu/ops/fast_stack.py:149-152) computes the same function; it
// is the front of the Harris-scored (nScoreType=0) extraction.
//
// What it computes, for EVERY canvas pixel p (levels and canvas padding
// alike; no level shapes):
//   score[p] = the FAST-9/16 score of p (fast_score.cuh), reading the canvas
//              edge-replicated (the wrapper's mode="edge" pad of 3);
//   keep[p]  = score[p] >= the score of each 3x3 neighbour that lies in the
//              canvas (reduce_window's -inf init: outside neighbours do not
//              count).
// Both outputs are exact (min/max of exactly rounded differences), so the
// kernel is bit-equal to its plain version.
//
// What bounds it on the H100: memory. At [8, 480, 640] it reads 9.8 MB and
// writes 9.8 MB of score and 2.5 MB of keep; ~150 min/max per pixel are
// cheaper than that. The design is K1's (fast_score_nms.cu): one block per
// 32x32 output tile, the (32+8)^2 window (stencil halo 3 + NMS halo 1) in
// shared memory loaded with coalesced row reads, the (32+2)^2 score tile in
// shared memory with -inf where the halo leaves the canvas, NMS from there.
// Unlike K1 it writes every canvas pixel: there is no level to skip.

#include "fast_score.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kWin = kTile + 8;
constexpr int kSc = kTile + 2;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kMaxLevels = 32;  // the port's level limit, as in K1 and K4

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
fast_score_rect_kernel(const float* __restrict__ canvas,
                       float* __restrict__ score_out,
                       unsigned char* __restrict__ keep_out, int H, int W) {
  const int lvl = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  __shared__ float win[kWin][kWin];
  __shared__ float score[kSc][kSc];
  const size_t plane_off = static_cast<size_t>(lvl) * H * W;
  const float* plane = canvas + plane_off;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;

  // window pixel (i, j) is canvas pixel (r0 - 4 + i, c0 - 4 + j), clamped
  for (int idx = tid; idx < kWin * kWin; idx += nthreads) {
    const int i = idx / kWin, j = idx % kWin;
    win[i][j] = fast::load_clamped(plane, H, W, r0 - 4 + i, c0 - 4 + j);
  }
  __syncthreads();

  // score pixel (i, j) is canvas pixel (r0 - 1 + i, c0 - 1 + j); outside
  // the canvas it is -inf, so the NMS ignores it
  const float neg_inf = -__int_as_float(0x7f800000);
  for (int idx = tid; idx < kSc * kSc; idx += nthreads) {
    const int i = idx / kSc, j = idx % kSc;
    const int y = r0 - 1 + i, x = c0 - 1 + j;
    const bool in_canvas = y >= 0 && y < H && x >= 0 && x < W;
    score[i][j] = in_canvas ? fast::score(&win[0][0], kWin, i + 3, j + 3) : neg_inf;
  }
  __syncthreads();

  for (int i = threadIdx.y; i < kTile; i += kThreadsY) {
    const int y = r0 + i;
    const int x = c0 + threadIdx.x;
    if (y >= H || x >= W) continue;
    const float c = score[i + 1][threadIdx.x + 1];
    float mx = c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, score[i + dy][threadIdx.x + dx]);
    const size_t o = plane_off + static_cast<size_t>(y) * W + x;
    score_out[o] = c;
    keep_out[o] = c >= mx ? 1 : 0;
  }
}

}  // namespace

extern "C" int fast_score_rect(const void* canvas, void* score, void* keep,
                               int L, int H, int W, void* stream) {
  if (L < 1 || L > kMaxLevels || H < 1 || W < 1) return cudaErrorInvalidValue;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, L);
  const dim3 block(kThreadsX, kThreadsY);
  fast_score_rect_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(canvas), static_cast<float*>(score),
      static_cast<unsigned char*>(keep), H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
