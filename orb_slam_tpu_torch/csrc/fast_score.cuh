// The FAST-9/16 score of one pixel of a window in shared memory, shared by
// kernels K1 (fast_score_nms.cu), K3 (fast_score_rect.cu) and K4
// (fast_cell_topk.cu).
//
//   d_k   = I(p + circle_k) - I(p), k = 0..15 (exactly rounded f32);
//   score = max( max_s min_{j in arc s} d_j , -min_s max_{j in arc s} d_j )
//           over the 16 circular arcs of 9, arc s = [s, s + 8] mod 16.
//
// The 16 arc minima and maxima come from the circular prefix/suffix sliding
// window of the JAX package's _circ9_minmax (orb_slam_tpu/ops/
// pallas_fast.py:88-118, van Herk / Gil-Werman on the circle): arc s spans a
// suffix of one 8-block and a prefix of the other, so each of min and max
// costs 7 + 7 prefix/suffix steps per block pair and 16 combines (44), then
// 15 + 15 to combine the arcs and 1 final max: 135 operations with the 16
// differences, against 304 for the 16 arcs taken one by one. The arcs are
// taken on the intensities I(p + circle_k) and the centre is subtracted
// from the two results only: rounding is monotone, so fl(x - c) commutes
// with min and max, and the two subtractions give the same bits as the 16
// (2 + 119 min/max in all).
//
// Every value is a min or max of exact differences, so the score is the
// same in any reduction order: bit-equal to the plain PyTorch versions
// (ops/fast.py::fast_score_stack) and to the Pallas kernels, whatever tree
// they use.

#pragma once

#include <cuda_runtime.h>

namespace fast {

// The 16 circular 9-arc minima (kMin) or maxima of d: arc s = [s, s + 8].
// P[b][i] = op(d[8b .. 8b+i]), S[b][i] = op(d[8b+i .. 8b+7]); arc s < 8 is
// op(S[0][s], P[1][s]), arc s >= 8 is op(S[1][s-8], P[0][s-8]).
template <bool kMin>
__device__ __forceinline__ void circ9(const float (&d)[16], float (&arc)[16]) {
  auto op = [](float a, float b) { return kMin ? fminf(a, b) : fmaxf(a, b); };
  float P[2][8], S[2][8];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    P[b][0] = d[8 * b];
    S[b][7] = d[8 * b + 7];
#pragma unroll
    for (int i = 1; i < 8; ++i) P[b][i] = op(P[b][i - 1], d[8 * b + i]);
#pragma unroll
    for (int i = 6; i >= 0; --i) S[b][i] = op(d[8 * b + i], S[b][i + 1]);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    arc[s] = op(S[0][s], P[1][s]);
    arc[s + 8] = op(S[1][s], P[0][s]);
  }
}

// Score of window pixel (wy, wx); `win` is row-major with row stride
// `stride`, and the pixel must have 3 window pixels on every side.
__device__ __forceinline__ float score(const float* win, int stride, int wy,
                                       int wx) {
  // Bresenham circle of radius 3 in circular order (ops/fast.py
  // FAST_CIRCLE); compile-time offsets once the loop is unrolled
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float* p = win + wy * stride + wx;
  const float c = *p;
  float v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = p[kDy[k] * stride + kDx[k]];
  float mn[16], mx[16];
  circ9<true>(v, mn);
  circ9<false>(v, mx);
  float hi = mn[0];  // max over arcs of the arc minimum of I
  float lo = mx[0];  // min over arcs of the arc maximum of I
#pragma unroll
  for (int s = 1; s < 16; ++s) {
    hi = fmaxf(hi, mn[s]);
    lo = fminf(lo, mx[s]);
  }
  // x -> fl(x - c) is monotone, so it commutes with every min and max:
  // hi - c is the max over arcs of the arc minimum of d, lo - c the min
  // over arcs of the arc maximum of d
  const float bright = hi - c, dark = lo - c;
  return fmaxf(bright, -dark);
}

// The score of every pixel of a window that holds one value c everywhere:
// all 16 differences are v = c - c, so every arc minimum and maximum is v
// and the score is fmaxf(v, -v), the last step of `score` (+0 for any
// finite c, NaN for an infinite or NaN c).
__device__ __forceinline__ float score_uniform(float c) {
  const float v = c - c;
  return fmaxf(v, -v);
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
