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
// What bounds it on the H100: the min/max of the stencil (119 per scored
// pixel, which the SMs issue at half the FMA rate); the canvas bytes (7.6 MB of level pixels at [8, 480, 640]) cost
// less. The design:
//   - one block of 256 threads per 32x32 tile that meets a level, and no
//     other, so the canvas outside the levels (~55% at [8, 480, 640])
//     launches nothing and is left unwritten; a block finds its tile from a
//     table passed by value (this replaces the Pallas kernel's
//     scalar-prefetched block table): 3 segments of whole tile rows per
//     level, the inner rows of every level first, the top and bottom rows
//     (whose unmasked score rows are fewer) last, so that the cheap tiles
//     fill the end of the launch, where the SMs would otherwise wait on the
//     last full tiles (level order was slower on the H100);
//   - the tile body is fast_tile.cuh's masked score tile, shared with K4;
//   - each thread writes its 4 adjacent pixels of one row, one 16-byte
//     store where the row and the pointers allow.

#include <cstdint>

#include "fast_tile.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxSegments = 3 * kMaxLevels;

// The blocks run through 3L segments, each a run of whole tile rows of one
// level (see ops/fast_score_nms.py::tile_table for the order).
struct TileTable {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int lvl[kMaxSegments];
  int start[kMaxSegments];  // first block of each segment
  int r0[kMaxSegments];     // r0 of the segment's first tile row
  int n_tx[kMaxSegments];   // tiles per tile row: ceil(w / 32)
};

__global__ void __launch_bounds__(fast::kTileThreads)
fast_score_nms_kernel(const float* __restrict__ canvas, float* __restrict__ out,
                      TileTable table, int n_seg, int H, int W, int border,
                      bool vec) {
  __shared__ fast::TileSmem sm;
  const int b = blockIdx.x;
  int seg = 0;
  while (seg + 1 < n_seg && b >= table.start[seg + 1]) ++seg;
  const int lvl = table.lvl[seg];
  const int local = b - table.start[seg];
  const int ty = local / table.n_tx[seg];
  const int r0 = table.r0[seg] + ty * fast::kTile;
  const int c0 = (local - ty * table.n_tx[seg]) * fast::kTile;
  const size_t plane_off = static_cast<size_t>(lvl) * H * W;

  float s[4];
  fast::masked_score_tile(canvas + plane_off, H, W, r0, c0, table.h[lvl],
                          table.w[lvl], border, vec, sm, s);

  const int y = r0 + fast::tile_row(threadIdx.x);
  const int x = c0 + fast::tile_col(threadIdx.x);
  if (y >= H) return;
  const size_t o = plane_off + static_cast<size_t>(y) * W + x;
  if (vec && x + 4 <= W) {
    *reinterpret_cast<float4*>(out + o) = make_float4(s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (x + q < W) out[o + q] = s[q];
  }
}

}  // namespace

// table: L rows of (h, w), then 3L rows of (level, first block, r0 of the
// first tile row, tiles per tile row), host memory; n_blocks = the number of
// tiles that meet a level.
extern "C" int fast_score_nms(const void* canvas, void* out, const void* table,
                              int n_blocks, int L, int H, int W, int border,
                              void* stream) {
  if (L < 1 || L > kMaxLevels || H < 1 || W < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  TileTable t{};
  const int* rows = static_cast<const int*>(table);
  for (int l = 0; l < L; ++l) {
    t.h[l] = rows[2 * l];
    t.w[l] = rows[2 * l + 1];
  }
  const int* segs = rows + 2 * L;
  for (int s = 0; s < 3 * L; ++s) {
    t.lvl[s] = segs[4 * s];
    t.start[s] = segs[4 * s + 1];
    t.r0[s] = segs[4 * s + 2];
    t.n_tx[s] = segs[4 * s + 3] > 0 ? segs[4 * s + 3] : 1;
  }
  // 16-byte window reads and stores: every row start aligned
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(canvas) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  fast_score_nms_kernel<<<n_blocks, fast::kTileThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(canvas), static_cast<float*>(out), t, 3 * L, H,
      W, border, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
