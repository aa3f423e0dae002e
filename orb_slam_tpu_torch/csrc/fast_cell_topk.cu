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
// What bounds it on the H100: operations. Each strip pixel costs ~150
// min/max for score, NMS and mask plus ~6 per top-K round; the input is read
// once (~3.8 MB at 640x480, 8 levels) and the outputs are a few KB. The
// design:
//   - one block per table entry, one warp per 32x32 cell (BW/32 warps); the
//     block finds its (level, r0, c0) from a per-level table passed by value
//     (the Pallas kernel's scalar-prefetched block table);
//   - the (32+8) x (BW+8) window, the (32+2) x (BW+2) score strip and the
//     32 x BW masked strip live in dynamic shared memory (110 KB at
//     BW = 256): nothing but the K candidates per cell reaches device memory;
//   - top-K: lane x of a cell's warp owns column x; a round is a warp max
//     (shuffles), each lane's first matching row (the smallest packed
//     position of its column), a warp min, and one shared-memory store.

#include "fast_score.cuh"

namespace {

constexpr int kBH = 32;           // cell edge = strip height = warp width
constexpr int kMaxCells = 8;      // cells per strip, BW = 32 * cells <= 256
constexpr int kMaxLevels = 32;
constexpr int kSentinel = 1 << 30;

struct LevelTable {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels + 1];  // first table entry of each level, then the total
  int r_first[kMaxLevels];    // r0 of the level's first strip row
  int n_cols[kMaxLevels];     // strips per strip row
};

__global__ void __launch_bounds__(kBH * kMaxCells)
fast_cell_topk_kernel(const float* __restrict__ canvas, float* __restrict__ vals,
                      int* __restrict__ pos, LevelTable table, int L, int H,
                      int W, int BW, int K, int border) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  int lvl = 0;
  while (lvl + 1 < L && b >= table.start[lvl + 1]) ++lvl;
  const int local = b - table.start[lvl];
  const int r0 = table.r_first[lvl] + (local / table.n_cols[lvl]) * kBH;
  const int c0 = (local % table.n_cols[lvl]) * BW;
  const int h = table.h[lvl];
  const int w = table.w[lvl];

  const int win_w = BW + 8;  // window: canvas (r0 - 4 + i, c0 - 4 + j)
  const int sc_w = BW + 2;   // score: canvas (r0 - 1 + i, c0 - 1 + j)
  float* win = smem;                          // [kBH + 8][win_w]
  float* score = win + (kBH + 8) * win_w;     // [kBH + 2][sc_w]
  float* strip = score + (kBH + 2) * sc_w;    // [kBH][BW] masked scores
  const float* plane = canvas + static_cast<size_t>(lvl) * H * W;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  for (int idx = tid; idx < (kBH + 8) * win_w; idx += nthreads) {
    const int i = idx / win_w, j = idx % win_w;
    win[idx] = fast::load_clamped(plane, H, W, r0 - 4 + i, c0 - 4 + j);
  }
  __syncthreads();
  for (int idx = tid; idx < (kBH + 2) * sc_w; idx += nthreads) {
    const int i = idx / sc_w, j = idx % sc_w;
    score[idx] = fast::score(win, win_w, i + 3, j + 3);
  }
  __syncthreads();
  for (int idx = tid; idx < kBH * BW; idx += nthreads) {
    const int i = idx / BW, j = idx % BW;
    const float c = score[(i + 1) * sc_w + j + 1];
    float mx = c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, score[(i + dy) * sc_w + j + dx]);
    const int y = r0 + i, x = c0 + j;
    const bool inb = y >= border && y < h - border && x >= border && x < w - border;
    strip[idx] = (c >= mx && inb) ? c : 0.0f;
  }
  __syncthreads();

  const int cell = tid / kBH;
  const int lane = tid % kBH;
  const int col = cell * kBH + lane;
  const int n_cells = BW / kBH;
  const size_t out0 = (static_cast<size_t>(b) * n_cells + cell) * K;
  for (int k = 0; k < K; ++k) {
    float m = strip[col];
    for (int y = 1; y < kBH; ++y) m = fmaxf(m, strip[y * BW + col]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    int p = kSentinel;  // smallest y of this column holding the max (> 0)
    for (int y = 0; y < kBH; ++y) {
      const float v = strip[y * BW + col];
      if (v == m && v > 0.0f) {
        p = (y + r0) * 65536 + (col + c0);
        break;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) p = min(p, __shfl_xor_sync(0xffffffffu, p, off));
    if (p != kSentinel && (p % 65536) == col + c0) strip[(p / 65536 - r0) * BW + col] = 0.0f;
    if (lane == 0) {
      vals[out0 + k] = m;
      pos[out0 + k] = p;
    }
    __syncwarp();
  }
}

}  // namespace

// table: L rows of (h, w, first entry, r0 of the first strip row, strips per
// strip row), host memory; n_blocks = the number of table entries.
extern "C" int fast_cell_topk(const void* canvas, void* vals, void* pos,
                              const void* table, int n_blocks, int L, int H,
                              int W, int BW, int K, int border, void* stream) {
  if (L < 1 || L > kMaxLevels || H < 1 || W < 1 || n_blocks < 1 || K < 1 ||
      BW < kBH || BW > kBH * kMaxCells || BW % kBH != 0)
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
  const int smem =
      ((kBH + 8) * (BW + 8) + (kBH + 2) * (BW + 2) + kBH * BW) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fast_cell_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fast_cell_topk_kernel<<<n_blocks, BW, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(canvas), static_cast<float*>(vals),
      static_cast<int*>(pos), t, L, H, W, BW, K, border);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
