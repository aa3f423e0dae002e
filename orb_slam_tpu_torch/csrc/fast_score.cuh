// The FAST-9/16 score of one pixel of a window in shared memory, shared by
// kernels K1 (fast_score_nms.cu), K3 (fast_score_rect.cu) and K4
// (fast_cell_topk.cu).
//
//   d_k   = I(p + circle_k) - I(p), k = 0..15 (exactly rounded f32);
//   score = max( max_s min_{j in arc s} d_j , -min_s max_{j in arc s} d_j )
//           over the 16 circular arcs of 9.
//
// Every value is a min or max of exact differences, so the score is the
// same in any reduction order: bit-equal to the plain PyTorch versions
// (ops/fast.py::fast_score_stack) and to the Pallas kernels, whatever tree
// they use.

#pragma once

#include <cuda_runtime.h>

namespace fast {

// Bresenham circle of radius 3 in circular order (ops/fast.py FAST_CIRCLE)
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};

// Score of window pixel (wy, wx); `win` is row-major with row stride
// `stride`, and the pixel must have 3 window pixels on every side.
__device__ __forceinline__ float score(const float* win, int stride, int wy,
                                       int wx) {
  const float c = win[wy * stride + wx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    d[k] = win[(wy + kCircleDy[k]) * stride + wx + kCircleDx[k]] - c;
  float bright = 0.0f;  // max over arcs of the arc minimum
  float dark = 0.0f;    // min over arcs of the arc maximum
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mn = d[s], mx = d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float v = d[(s + j) & 15];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    bright = s == 0 ? mn : fmaxf(bright, mn);
    dark = s == 0 ? mx : fminf(dark, mx);
  }
  return fmaxf(bright, -dark);
}

// Clamped load: canvas reads outside [0, H) x [0, W) take the nearest edge
// pixel, which is the Pallas wrappers' mode="edge" pad.
__device__ __forceinline__ float load_clamped(const float* plane, int H, int W,
                                              int y, int x) {
  y = min(max(y, 0), H - 1);
  x = min(max(x, 0), W - 1);
  return plane[static_cast<size_t>(y) * W + x];
}

}  // namespace fast
