// The masked FAST score of one 32x32 tile of the packed pyramid canvas,
// shared by kernels K1 (fast_score_nms.cu) and K4 (fast_cell_topk.cu).
//
// What it computes, for the tile whose top-left pixel is (r0, c0) of a
// level of true size (h, w) in a [H, W] canvas plane:
//   s(p) = the FAST score of p (fast_score.cuh) if p is a 3x3 maximum of the
//          score and p lies in [border, h-border) x [border, w-border),
//          else +0.0,
// with every canvas read clamped to the canvas edge (the Pallas wrappers'
// mode="edge" pad; so the score halo past the canvas is scored too, not
// -inf as in K3). Each thread of the 256 gets the 4 adjacent pixels
// (r0 + tile_row(tid), c0 + tile_col(tid) + q), q = 0..3, in registers.
//
// Why it is built so: the stencil's min/max, not memory, bounds the tile on
// the H100 (119 min/max of ~140 instructions per scored pixel, and the SMs
// issue min/max at half the FMA rate, ~63 per SM per clock as
// csrc/minmax_probe.cu measures it); the time a block waits on its window
// is covered by the other blocks on its SM, which keep the min/max busy.
//   - the (32+8)^2 window (stencil halo 3 + NMS halo 1) goes to shared
//     memory in 16-byte row reads where the window's columns lie inside the
//     canvas and the pointers allow (rows clamp per row), else in clamped
//     scalar reads whose row and column come from loop counters; a thread
//     issues all its reads before its shared-memory stores;
//   - the (32+2)^2 score tile: warp = row, lane = column, so that the 17
//     window reads of a warp are 32 consecutive floats of one row; the two
//     extra columns go to the warps with one row fewer; the score rows are
//     padded to 35 floats, so that the NMS reads of rows 4 apart hit other
//     banks; only the score rows that an unmasked pixel's 3x3 maximum reads
//     are scored (canvas rows border - 1 .. h - border), which leaves out
//     about half of the rows of a level's top and bottom tiles;
//   - the 3x3 maximum is taken as column maxima, then row maxima.
// Every value is a min or max of exactly rounded differences, so the tile
// is bit-equal to the plain versions whatever order it reduces in.

#pragma once

#include "fast_score.cuh"

namespace fast {

constexpr int kTile = 32;                 // output tile edge = warp width
constexpr int kTileWin = kTile + 8;       // window edge (halo 4 each side)
constexpr int kTileSc = kTile + 2;        // score tile edge (NMS halo 1)
constexpr int kTileScStride = kTileSc + 1;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
static_assert(kTile * kTile == 4 * kTileThreads,
              "each thread holds 4 adjacent pixels of one tile row");

struct TileSmem {
  __align__(16) float win[kTileWin][kTileWin];  // canvas (r0-4+i, c0-4+j)
  float sc[kTileSc][kTileScStride];             // score of (r0-1+i, c0-1+j)
};

// The tile row and the first of the 4 tile columns of thread tid.
__device__ __forceinline__ int tile_row(int tid) { return tid >> 3; }
__device__ __forceinline__ int tile_col(int tid) { return (tid & 7) * 4; }

// The window in kN elements of kW per row (quads or pixels), kN / 256
// rounded up per thread: all of a thread's loads are issued before its
// stores to shared memory, so that their latencies overlap. Element idx =
// tid + 256 u is at (i, j) = (idx / kW, idx % kW), from counters: each u
// advances 256 = (256 / kW) rows + (256 % kW) elements.
template <int kW, typename T, typename Load, typename Store>
__device__ __forceinline__ void load_rows(int tid, Load load, Store store) {
  constexpr int kN = kTileWin * kW;
  constexpr int kPer = (kN + kTileThreads - 1) / kTileThreads;
  T v[kPer];
  int i = tid / kW, j = tid - i * kW;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (i < kTileWin) v[u] = load(i, j);
    j += kTileThreads % kW;
    i += kTileThreads / kW;
    if (j >= kW) {
      j -= kW;
      ++i;
    }
  }
  i = tid / kW;
  j = tid - i * kW;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (i < kTileWin) store(i, j, v[u]);
    j += kTileThreads % kW;
    i += kTileThreads / kW;
    if (j >= kW) {
      j -= kW;
      ++i;
    }
  }
}

// window pixel (i, j) = canvas pixel (r0 - 4 + i, c0 - 4 + j), clamped.
// vec: the plane pointer is 16-byte aligned and W % 4 == 0.
__device__ __forceinline__ void load_tile_window(const float* __restrict__ plane,
                                                 int H, int W, int r0, int c0,
                                                 bool vec, TileSmem& sm, int tid) {
  if (vec && c0 >= 4 && c0 + kTile + 4 <= W) {
    // 10 quads of 16 bytes per row, rows clamped
    load_rows<kTileWin / 4, float4>(
        tid,
        [&](int i, int q) {
          const int y = min(max(r0 - 4 + i, 0), H - 1);
          return *reinterpret_cast<const float4*>(
              plane + static_cast<size_t>(y) * W + c0 - 4 + 4 * q);
        },
        [&](int i, int q, float4 v) {
          *reinterpret_cast<float4*>(&sm.win[i][4 * q]) = v;
        });
  } else {
    load_rows<kTileWin, float>(
        tid,
        [&](int i, int j) { return load_clamped(plane, H, W, r0 - 4 + i, c0 - 4 + j); },
        [&](int i, int j, float v) { sm.win[i][j] = v; });
  }
}

// Score pixel (i, j) = window pixel (i + 3, j + 3), for the rows i_lo ..
// i_hi. Warp w scores columns 0 .. 31 of rows i_lo + w, i_lo + w + 8, ...,
// lane = column; the threads of warps 2 .. 7, which have one row fewer of
// all 34, take the last two columns.
__device__ __forceinline__ void score_tile_rows(TileSmem& sm, int tid, int i_lo,
                                                int i_hi) {
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = i_lo + warp; i <= i_hi; i += kTileWarps)
    sm.sc[i][lane] = score(&sm.win[0][0], kTileWin, i + 3, lane + 3);
  constexpr int kSpare = (kTileWarps - kTileSc % kTileWarps) % kTileWarps * 32;
  const int n2 = 2 * (i_hi - i_lo + 1);
  const int e = tid - (kTileThreads - kSpare);
  for (int idx = e >= 0 ? e : n2; idx < n2; idx += kSpare) {
    const int i = i_lo + (idx >> 1), j = kTile + (idx & 1);
    sm.sc[i][j] = score(&sm.win[0][0], kTileWin, i + 3, j + 3);
  }
}

// The whole tile: window, score, 3x3 maximum and mask; s[q] is the masked
// score of canvas pixel (r0 + tile_row(tid), c0 + tile_col(tid) + q). Every
// thread of the block must call it (it holds two __syncthreads).
__device__ __forceinline__ void masked_score_tile(const float* __restrict__ plane,
                                                  int H, int W, int r0, int c0,
                                                  int h, int w, int border,
                                                  bool vec, TileSmem& sm,
                                                  float (&s)[4]) {
  const int tid = threadIdx.x;
  load_tile_window(plane, H, W, r0, c0, vec, sm, tid);
  __syncthreads();
  // only the score rows that the 3x3 maximum of an interior pixel reads:
  // canvas rows border - 1 .. h - border; every other pixel is masked, so
  // the rows left unscored change no output
  score_tile_rows(sm, tid, max(0, border - r0),
                  min(kTileSc - 1, h - border - r0 + 1));
  __syncthreads();
  const int oi = tile_row(tid), oj = tile_col(tid);
  float colmax[6];
#pragma unroll
  for (int dx = 0; dx < 6; ++dx)
    colmax[dx] = fmaxf(fmaxf(sm.sc[oi][oj + dx], sm.sc[oi + 1][oj + dx]),
                       sm.sc[oi + 2][oj + dx]);
  const int y = r0 + oi, x = c0 + oj;
  const bool row_in = y >= border && y < h - border;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float c = sm.sc[oi + 1][oj + q + 1];
    const float mx = fmaxf(fmaxf(colmax[q], colmax[q + 1]), colmax[q + 2]);
    const bool inside = row_in && x + q >= border && x + q < w - border;
    s[q] = (c >= mx && inside) ? c : 0.0f;
  }
}

}  // namespace fast
