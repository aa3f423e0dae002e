// Kernel K4: FAST-9/16 score + 3x3 NMS + border mask + per-cell top-K over
// the packed pyramid canvas, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orb_slam_tpu/ops/pallas_fast.py:
// _make_cell_topk_kernel (entry fast_cell_topk_packed, :287-427), the
// detection front of the cell-fused detector fast_stack._detect_cells_fused.
//
// What it computes, for each entry b of the block table (level l, a strip of
// 32 rows x BW columns at (r0, c0), cut into BW/32 cells of 32x32; the table
// lists the strips that meet the level's detectable interior):
//   s(p)  = FAST score of p (fast_score.cuh) if p is a 3x3 maximum of the
//           score (the halo read edge-replicated, as the Pallas wrapper's
//           mode="edge" pad) and p lies in [border, h-border) x
//           [border, w-border), else 0;
//   then K rounds per cell, on a working copy of s:
//     vals[b, cell, k] = max over the cell;
//     pos[b, cell, k]  = the smallest packed position y*65536 + x among the
//                        cell's pixels equal to that max and > 0, or 2^30
//                        when there is none;
//     the pixel at pos (only it) becomes 0.
// This is the Pallas kernel's rule to the letter (pallas_fast.py:355-366):
// ties go to the lowest y, then the lowest x, and an empty cell emits value
// max (0 for any real frame) with position 2^30. All values are exact, so
// the kernel is bit-equal to its plain version.
//
// What bounds it on the H100: the stencil's min/max (119 per scored pixel,
// issued at half the FMA rate); the input is read once (~3.8 MB at 640x480, 8 levels) and
// the outputs are a few KB. The design:
//   - one block of 256 threads per cell, n_blocks x BW/32 blocks; the block
//     finds its strip's (level, r0, c0) from a per-level table passed by
//     value (the Pallas kernel's scalar-prefetched block table);
//   - a cell wholly outside the detectable interior (22% of the cells at
//     [8, 480, 640]: the columns past w - border of a level's last strip)
//     writes value +0.0 and position 2^30 in all K slots without the
//     stencil: every pixel of it is masked to +0.0, so that is the rule's
//     output there;
//   - any other cell runs fast_tile.cuh's masked score tile (shared with
//     K1), which leaves each thread 4 adjacent pixels of one row in
//     registers; a top-K round is a block-wide arg-max of (max value,
//     smallest position among the pixels > 0 equal to it): the thread's 4
//     pixels, a shuffle tree in the warp, the 8 warps' candidates through
//     shared memory, combined by warp 0 in a shuffle tree of 8 lanes; the
//     thread that holds the winner zeroes it in its registers, and only its
//     warp recomputes its candidate for the next round (the others' pixels
//     did not change), so a round's work is one warp's, not the block's;
//   - 11.2 KB of static shared memory per block and registers held to 5
//     blocks per SM, so that a block's top-K rounds, which are latency and
//     barriers, overlap the other blocks' stencils.

#include <cstdint>

#include "fast_tile.cuh"

namespace {

constexpr int kMaxCells = 8;      // cells per strip, BW = 32 * cells <= 256
constexpr int kMaxLevels = 32;
constexpr int kSentinel = 1 << 30;
// 5 blocks on an SM (47 registers, no spills): a block in its top-K rounds
// issues little, and the others keep the stencil's min/max busy
constexpr int kBlocksPerSM = 5;

struct LevelTable {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels + 1];  // first table entry of each level, then the total
  int r_first[kMaxLevels];    // r0 of the level's first strip row
  int n_cols[kMaxLevels];     // strips per strip row
};

// (value, position) of the arg-max of two candidates: the larger value, and
// the smaller position among those holding it (a candidate's position is
// 2^30 unless its value is > 0).
__device__ __forceinline__ void arg_max(float& m, int& p, float m2, int p2) {
  const float mm = fmaxf(m, m2);
  p = min(m == mm ? p : kSentinel, m2 == mm ? p2 : kSentinel);
  m = mm;
}

__global__ void __launch_bounds__(fast::kTileThreads, kBlocksPerSM)
fast_cell_topk_kernel(const float* __restrict__ canvas, float* __restrict__ vals,
                      int* __restrict__ pos, LevelTable table, int L, int H,
                      int W, int n_cells, int BW, int K, int border, bool vec) {
  __shared__ fast::TileSmem sm;
  __shared__ float red_m[fast::kTileWarps];  // each warp's candidate
  __shared__ int red_p[fast::kTileWarps];
  __shared__ int winner;                     // the round's position
  const int b = blockIdx.x / n_cells;
  const int cell = blockIdx.x - b * n_cells;
  int lvl = 0;
  while (lvl + 1 < L && b >= table.start[lvl + 1]) ++lvl;
  const int local = b - table.start[lvl];
  const int strip_row = local / table.n_cols[lvl];
  const int r0 = table.r_first[lvl] + strip_row * fast::kTile;
  const int c0 = (local - strip_row * table.n_cols[lvl]) * BW + cell * fast::kTile;
  const int h = table.h[lvl];
  const int w = table.w[lvl];
  const int tid = threadIdx.x;
  const size_t out0 = static_cast<size_t>(blockIdx.x) * K;

  // no pixel of the cell lies in [border, h-border) x [border, w-border)
  if (max(r0, border) >= min(r0 + fast::kTile, h - border) ||
      max(c0, border) >= min(c0 + fast::kTile, w - border)) {
    for (int k = tid; k < K; k += fast::kTileThreads) {
      vals[out0 + k] = 0.0f;
      pos[out0 + k] = kSentinel;
    }
    return;
  }

  float s[4];
  fast::masked_score_tile(canvas + static_cast<size_t>(lvl) * H * W, H, W, r0,
                          c0, h, w, border, vec, sm, s);
  const int pos0 = (r0 + fast::tile_row(tid)) * 65536 + c0 + fast::tile_col(tid);
  const int lane = tid & 31, warp = tid >> 5;
  // the warp's candidate: the thread's 4 pixels (the max, then the first
  // pixel > 0 holding it), then the shuffle tree; lane 0 posts it
  auto post_warp_candidate = [&]() {
    float m = fmaxf(fmaxf(fmaxf(s[0], s[1]), s[2]), s[3]);
    int p = kSentinel;
#pragma unroll
    for (int q = 3; q >= 0; --q)
      if (s[q] == m && s[q] > 0.0f) p = pos0 + q;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      arg_max(m, p, __shfl_xor_sync(0xffffffffu, m, off),
              __shfl_xor_sync(0xffffffffu, p, off));
    if (lane == 0) {
      red_m[warp] = m;
      red_p[warp] = p;
    }
  };
  post_warp_candidate();
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    // warp 0 combines the 8 warps' candidates: a shuffle tree over lanes
    // 0..7, which hold warps 0..7 (every group of 8 lanes holds the same)
    if (warp == 0) {
      float m = red_m[lane & 7];
      int p = red_p[lane & 7];
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        arg_max(m, p, __shfl_xor_sync(0xffffffffu, m, off),
                __shfl_xor_sync(0xffffffffu, p, off));
      if (lane == 0) {
        vals[out0 + k] = m;
        pos[out0 + k] = p;
        winner = p;
      }
    }
    __syncthreads();
    // the winning pixel is zeroed; only its warp's candidate changes (warp
    // w holds rows 4w .. 4w+3); with no winner nothing changes
    const int p = winner;
    if (p != kSentinel && warp == ((p >> 16) - r0) >> 2) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p == pos0 + q) s[q] = 0.0f;
      post_warp_candidate();
    }
    __syncthreads();
  }
}

}  // namespace

// table: L rows of (h, w, first entry, r0 of the first strip row, strips per
// strip row), host memory; n_blocks = the number of table entries.
extern "C" int fast_cell_topk(const void* canvas, void* vals, void* pos,
                              const void* table, int n_blocks, int L, int H,
                              int W, int BW, int K, int border, void* stream) {
  if (L < 1 || L > kMaxLevels || H < 1 || W < 1 || n_blocks < 1 || K < 1 ||
      BW < fast::kTile || BW > fast::kTile * kMaxCells || BW % fast::kTile != 0)
    return cudaErrorInvalidValue;
  LevelTable t{};
  const int* rows = static_cast<const int*>(table);
  for (int l = 0; l < L; ++l) {
    t.h[l] = rows[5 * l];
    t.w[l] = rows[5 * l + 1];
    t.start[l] = rows[5 * l + 2];
    t.r_first[l] = rows[5 * l + 3];
    t.n_cols[l] = rows[5 * l + 4] > 0 ? rows[5 * l + 4] : 1;
  }
  t.start[L] = n_blocks;
  const int n_cells = BW / fast::kTile;
  // 16-byte window reads: every row start aligned
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(canvas) % 16 == 0;
  fast_cell_topk_kernel<<<n_blocks * n_cells, fast::kTileThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(canvas), static_cast<float*>(vals),
      static_cast<int*>(pos), t, L, H, W, n_cells, BW, K, border, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
