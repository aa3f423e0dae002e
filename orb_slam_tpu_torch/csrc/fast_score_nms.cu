// Kernel K1: FAST-9/16 score + 3x3 non-maximum suppression + border mask
// over the packed pyramid canvas, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orb_slam_tpu/ops/pallas_fast.py:
// _make_packed_kernel (entry fast_score_nms_packed), as the main path calls
// it: tree=True, border=16 (fast_stack.py:188).
//
// What it computes, per level pixel p of a level of true size (h, w):
//   score = the FAST-9/16 score of p (fast_score.cuh);
//   out   = score if score >= every score of its 3x3 neighbourhood and p
//           lies in [border, h-border) x [border, w-border), else 0.
// Reads outside the canvas clamp to its edge, which is the Pallas wrapper's
// mode="edge" pad (pallas_fast.py:224-225). Every value is a min or max of
// exact differences, so the result is bit-exact in any reduction order.
//
// What bounds it on the H100: memory. One frame reads the [8, 480, 640] f32
// canvas (~9.8 MB, plus halo re-reads) and writes as much; the ~120 min/max
// per pixel of the shared stencil are cheap against that. The design:
//   - one block per 32x32 output tile per level; blocks whose tile lies
//     wholly outside the level exit at once (this replaces the Pallas
//     kernel's scalar-prefetched block table), so the ~55% of the canvas
//     that holds no level costs nothing and is left unwritten;
//   - the (32+8) x (32+8) input window (stencil halo 3 + NMS halo 1) is
//     loaded once into shared memory with coalesced row reads, the score of
//     the (32+2) x (32+2) halo tile goes to shared memory, and the NMS and
//     border mask read it from there: no intermediate touches device memory.

#include "fast_score.cuh"

namespace {

constexpr int kTile = 32;              // output tile edge
constexpr int kWin = kTile + 8;        // input window edge (halo 4 each side)
constexpr int kSc = kTile + 2;         // score tile edge (NMS halo 1)
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kMaxLevels = 32;

struct LevelShapes {
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
fast_score_nms_kernel(const float* __restrict__ canvas, float* __restrict__ out,
                      LevelShapes shapes, int H, int W, int border) {
  const int lvl = blockIdx.z;
  const int h = shapes.h[lvl];
  const int w = shapes.w[lvl];
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  if (r0 >= h || c0 >= w) return;  // tile wholly outside the level

  __shared__ float win[kWin][kWin];
  __shared__ float score[kSc][kSc];
  const float* plane = canvas + static_cast<size_t>(lvl) * H * W;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;

  // window pixel (i, j) is canvas pixel (r0 - 4 + i, c0 - 4 + j), clamped
  for (int idx = tid; idx < kWin * kWin; idx += nthreads) {
    const int i = idx / kWin, j = idx % kWin;
    win[i][j] = fast::load_clamped(plane, H, W, r0 - 4 + i, c0 - 4 + j);
  }
  __syncthreads();

  // score pixel (i, j) is canvas pixel (r0 - 1 + i, c0 - 1 + j), i.e.
  // window pixel (i + 3, j + 3)
  for (int idx = tid; idx < kSc * kSc; idx += nthreads) {
    const int i = idx / kSc, j = idx % kSc;
    score[i][j] = fast::score(&win[0][0], kWin, i + 3, j + 3);
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
    const bool inside = y >= border && y < h - border && x >= border && x < w - border;
    out[static_cast<size_t>(lvl) * H * W + static_cast<size_t>(y) * W + x] =
        (inside && c >= mx) ? c : 0.0f;
  }
}

}  // namespace

extern "C" int fast_score_nms(const void* canvas, void* out, const void* hw,
                              int L, int H, int W, int border, void* stream) {
  if (L < 1 || L > kMaxLevels || H < 1 || W < 1) return cudaErrorInvalidValue;
  LevelShapes shapes{};
  const int* hw_host = static_cast<const int*>(hw);
  for (int l = 0; l < L; ++l) {
    shapes.h[l] = hw_host[2 * l];
    shapes.w[l] = hw_host[2 * l + 1];
  }
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, L);
  const dim3 block(kThreadsX, kThreadsY);
  fast_score_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(canvas), static_cast<float*>(out), shapes, H, W,
      border);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
