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
// What bounds it on the H100: memory, in principle. At [8, 480, 640] it reads
// 9.8 MB and writes 9.8 MB of score and 2.5 MB of keep (6.6 us at 3.35
// TB/s); the 121 min/max and subtractions of the stencil (fast_score.cuh)
// per pixel of the levels cost less than that at the f32 peak, but min/max
// do not issue at the FMA rate, so on the tiles that hold level pixels the
// stencil is the larger cost. The design:
//   - one block of 256 threads per 32x32 output tile; the (32+8)^2 window
//     (stencil halo 3 + NMS halo 1) goes to shared memory, in 16-byte
//     row reads where the window lies inside the canvas and the pointers
//     allow, else in clamped scalar reads;
//   - while loading, each thread compares its pixels' bit patterns with
//     the window's first pixel, and __syncthreads_or tells the block
//     whether the whole window holds one value. Such a tile (the canvas
//     the main path builds is ~58% zero padding outside the levels) writes
//     the known outputs without the stencil: the score of a uniform window
//     (fast::score_uniform) everywhere, keep = (s >= s). Bits, not ==, so
//     -0.0 and +0.0 are not merged; exact for any input;
//   - any other tile scores its (32+2)^2 halo tile into shared memory, -inf
//     where the halo leaves the canvas (that test only on tiles at the
//     canvas edge), one row per warp with lane = column, so that a warp's
//     window reads are 32 consecutive floats; the score rows are padded to
//     35 floats, so that the NMS reads of rows 4 apart hit other banks; the
//     3x3 maximum is taken as column maxima, then row maxima;
//   - each thread writes 4 adjacent pixels of one row: one 16-byte score
//     store and one 4-byte keep store where the row allows.

#include <cstdint>

#include "fast_score.cuh"

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 32;
constexpr int kWinH = kTileH + 8, kWinW = kTileW + 8;
constexpr int kScH = kTileH + 2, kScW = kTileW + 2;
constexpr int kScStride = kScW + 1;  // rows 4 apart fall on other banks
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 32;  // the port's level limit, as in K1 and K4
static_assert(kTileW == 32 && kTileH * kTileW == 4 * kThreads,
              "a tile row is a warp; each thread writes 4 pixels of one row");

// Score pixel (i, j) of the tile: canvas pixel (r0 - 1 + i, c0 - 1 + j),
// window pixel (i + 3, j + 3). Warp w scores columns 0 .. 31 of rows w,
// w + kWarps, ..., lane = column, so that the 16 + 1 window reads of a
// warp are 32 consecutive floats of one row (no bank conflict); the last two
// columns go to the warps with the fewest rows. kEdge: the tile's halo may
// leave the canvas, where the score is -inf, so that the NMS ignores it.
template <bool kEdge>
__device__ __forceinline__ void score_tile(const float (&win)[kWinH][kWinW],
                                           float (&score)[kScH][kScStride],
                                           int r0, int c0, int H, int W, int tid) {
  const float neg_inf = -__int_as_float(0x7f800000);
  auto put = [&](int i, int j) {
    float s = fast::score(&win[0][0], kWinW, i + 3, j + 3);
    if (kEdge) {
      const int y = r0 - 1 + i, x = c0 - 1 + j;
      if (y < 0 || y >= H || x < 0 || x >= W) s = neg_inf;
    }
    score[i][j] = s;
  };
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = warp; i < kScH; i += kWarps) put(i, lane);
  // warps kScH % kWarps .. kWarps - 1 score one row fewer: they take the
  // last two columns
  constexpr int kSpare = (kWarps - kScH % kWarps) % kWarps * 32;
  const int e = tid - (kThreads - kSpare);
  for (int idx = e >= 0 ? e : kScH * 2; idx < kScH * 2; idx += kSpare)
    put(idx >> 1, kTileW + (idx & 1));
}

__global__ void __launch_bounds__(kThreads)
fast_score_rect_kernel(const float* __restrict__ canvas,
                       float* __restrict__ score_out,
                       unsigned char* __restrict__ keep_out, int H, int W,
                       bool vec) {
  const int lvl = blockIdx.z;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  __shared__ __align__(16) float win[kWinH][kWinW];
  __shared__ float score[kScH][kScStride];
  const size_t plane_off = static_cast<size_t>(lvl) * H * W;
  const float* plane = canvas + plane_off;
  const int tid = threadIdx.x;

  // window pixel (i, j) is canvas pixel (r0 - 4 + i, c0 - 4 + j), clamped
  const float first = fast::load_clamped(plane, H, W, r0 - 4, c0 - 4);
  const int first_bits = __float_as_int(first);
  bool differs = false;
  const bool inside = r0 >= 4 && c0 >= 4 && r0 + kTileH + 4 <= H &&
                      c0 + kTileW + 4 <= W;
  if (vec && inside) {
    constexpr int kQuads = kWinW / 4;
    for (int idx = tid; idx < kWinH * kQuads; idx += kThreads) {
      const int i = idx / kQuads, q = idx - i * kQuads;
      const float4 v = *reinterpret_cast<const float4*>(
          plane + static_cast<size_t>(r0 - 4 + i) * W + c0 - 4 + 4 * q);
      *reinterpret_cast<float4*>(&win[i][4 * q]) = v;
      differs |= __float_as_int(v.x) != first_bits ||
                 __float_as_int(v.y) != first_bits ||
                 __float_as_int(v.z) != first_bits ||
                 __float_as_int(v.w) != first_bits;
    }
  } else {
    for (int idx = tid; idx < kWinH * kWinW; idx += kThreads) {
      const int i = idx / kWinW, j = idx - i * kWinW;
      const float v = fast::load_clamped(plane, H, W, r0 - 4 + i, c0 - 4 + j);
      win[i][j] = v;
      differs |= __float_as_int(v) != first_bits;
    }
  }
  const bool uniform = !__syncthreads_or(differs);

  // output pixels (r0 + oi, c0 + oj .. c0 + oj + 3) of this thread
  const int oi = tid >> 3, oj = (tid & 7) * 4;
  float s[4];
  unsigned char k[4];
  if (uniform) {
    const float su = fast::score_uniform(first);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[q] = su;
      k[q] = su >= su ? 1 : 0;
    }
  } else {
    if (r0 >= 1 && c0 >= 1 && r0 + kTileH + 1 <= H && c0 + kTileW + 1 <= W)
      score_tile<false>(win, score, r0, c0, H, W, tid);
    else
      score_tile<true>(win, score, r0, c0, H, W, tid);
    __syncthreads();
    float nb[3][6];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 6; ++dx) nb[dy][dx] = score[oi + dy][oj + dx];
    // the 3x3 maximum as column maxima, then row maxima of those
    float colmax[6];
#pragma unroll
    for (int dx = 0; dx < 6; ++dx)
      colmax[dx] = fmaxf(fmaxf(nb[0][dx], nb[1][dx]), nb[2][dx]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float c = nb[1][q + 1];
      const float mx = fmaxf(fmaxf(colmax[q], colmax[q + 1]), colmax[q + 2]);
      s[q] = c;
      k[q] = c >= mx ? 1 : 0;
    }
  }

  const int y = r0 + oi, x = c0 + oj;
  if (y >= H) return;
  const size_t o = plane_off + static_cast<size_t>(y) * W + x;
  if (vec && x + 4 <= W) {
    *reinterpret_cast<float4*>(score_out + o) = make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<uchar4*>(keep_out + o) = make_uchar4(k[0], k[1], k[2], k[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (x + q < W) {
        score_out[o + q] = s[q];
        keep_out[o + q] = k[q];
      }
    }
  }
}

}  // namespace

extern "C" int fast_score_rect(const void* canvas, void* score, void* keep,
                               int L, int H, int W, void* stream) {
  if (L < 1 || L > kMaxLevels || H < 1 || W < 1) return cudaErrorInvalidValue;
  // 16-byte window reads and score stores, 4-byte keep stores: every row
  // start aligned
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(canvas) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(score) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(keep) % 4 == 0;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, L);
  fast_score_rect_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(canvas), static_cast<float*>(score),
      static_cast<unsigned char*>(keep), H, W, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
