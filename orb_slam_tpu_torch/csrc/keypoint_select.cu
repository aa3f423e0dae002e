// Kernel K5: the keypoint selection on the masked score canvas (the per-cell
// threshold fallback, the level's candidate pool, the quota redistribution
// and retainBest), for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package runs this tail as XLA ops
// (orb_slam_tpu/ops/fast_stack.py:297 `_select_from_masked`,
// orb_slam_tpu/ops/fast.py:103 `reference_quota`); in plain PyTorch it was
// about a thousand small launches per extraction (a pad, sums, a top-k over
// each level's region, a stable sort, a cummax and the redistribution's
// fixed number of passes), so it is written here as two launches.
//
// What it computes, for each level l of true size (h, w), with the grid
// (rows, cols, cellH, cellW), the pool size k_tot and the quota q of
// ops/fast_stack.py::KeypointSelector (the plain version, bit for bit):
//   - the region [border, border + rows*cellH) x [border, border + cols*cellW)
//     of the level's plane, read as 0 outside h x w (the canvas there is
//     left unwritten by K1 and never read);
//   - per cell: n_ini = pixels > th_ini; the cell's threshold th is th_ini if
//     n_ini > 3, else th_min; avail = pixels > th;
//   - the pool: the k_tot largest thresholded pixels of the level by the key
//     (score bits << 32 | ~flat), flat = y * (cols*cellW) + x in the region,
//     so ties go to the lower flat index (ops/sort.top_k's order); where
//     fewer than k_tot pixels pass, the lowest-index zero pixels fill it;
//   - the pool sorted stably by cell (zeros last), each entry ranked within
//     its cell; retain[cell] from reference_quota's redistribution, run to
//     its fixed point (the plain version's fixed number of passes ends
//     there too);
//   - the pool keeps an entry's score where rank < retain[cell], else 0,
//     padded with zeros at (0, 0) to P = max k_tot; the Qmax largest of it
//     by value, ties by pool position: xy [L, Qmax, 2] int32, score
//     [L, Qmax] f32, valid = score > 0 and slot < q.
// Scores and thresholds are only compared, never combined, so the result is
// exact in any order. The wrapper refuses negative thresholds, so every
// kept score is > 0 and every other pool value +0.0.
//
// What bounds it on the H100: latency. It reads the level pixels once (about
// 3.2 MB at [8, 480, 640], ~1 us at 3.35 TB/s) and writes a few KB; what
// costs is the chain of dependent steps of each level (a select over tens
// of thousands of pixels, a sort, a loop over the cells). The design:
//   - launch 1, one block per (level, cell): reads its cell once to count
//     n_ini and avail, then writes the cell's min(avail, k_tot) largest keys
//     to a scratch list, sorted descending (an exact radix select over the
//     cell's pixels, 8 bits a pass, where avail > k_tot; a rank-by-count
//     sort in shared memory). Any entry of the level's pool is among its
//     cell's k_tot largest, so the lists hold the whole pool;
//   - launch 2, one block per level: an exact radix select of the level's
//     k_tot-th key over its cells' lists (skipped where the level has at
//     most k_tot candidates), which cuts each sorted list at its pool
//     count: the pool, in cell order, is those prefixes, and an entry's
//     rank is its place in its list; one warp's redistribution; the
//     retained entries ranked by (score, pool position) in shared memory;
//     the remaining slots take the pool's zero entries in pool order.
// Shared memory is sized from the level table (k_tot and the cells of each
// level), so other image sizes and feature counts need no other code.

#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kCellThreads = 512;
constexpr int kLevelThreads = 1024;
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;

struct LevelTable {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int rows[kMaxLevels];
  int cols[kMaxLevels];
  int cell_h[kMaxLevels];
  int cell_w[kMaxLevels];
  int k_tot[kMaxLevels];
  int quota[kMaxLevels];
  int first_cell[kMaxLevels + 1];  // then the number of cells
  int first_key[kMaxLevels];       // scratch slots: k_tot per cell
};

// scratch per cell: how many keys its list holds, avail, and whether its
// threshold is th_min
struct CellInfo {
  int count;
  int avail;
  int low_th;
};

__device__ __forceinline__ unsigned long long pixel_key(float v, unsigned flat) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         (0xffffffffu - flat);
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The digit of the k_rem-th largest key among the histogrammed ones, for
// warp 0: the bins are read from the top; returns (in *s_out) the prefix
// with the digit set, what is left of k_rem below it, and whether every key
// of that bin is taken (then the select is done).
__device__ void pick_digit(const int* hist, int shift, unsigned long long prefix,
                           int k_rem, unsigned long long* s_prefix, int* s_krem,
                           int* s_done) {
  const int lane = lane_id();
  int cnt[8];
  int own = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cnt[j] = hist[kBins - 1 - (lane * 8 + j)];
    own += cnt[j];
  }
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  const int excl = incl - own;
  const unsigned hit = __ballot_sync(kFull, excl < k_rem && k_rem <= incl);
  if (lane == __ffs(hit) - 1) {
    int above = excl;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (above + cnt[j] >= k_rem) {
        const unsigned long long d = kBins - 1 - (lane * 8 + j);
        const int left = k_rem - above;
        *s_prefix = prefix | (d << shift);
        *s_krem = left;
        *s_done = cnt[j] == left || shift == 0;
        break;
      }
      above += cnt[j];
    }
  }
}

__global__ void __launch_bounds__(kCellThreads)
keypoint_select_cells_kernel(const float* __restrict__ canvas, LevelTable t,
                             int L, int H, int W, int border, float th_ini,
                             float th_min,
                             unsigned long long* __restrict__ keys,
                             CellInfo* __restrict__ info) {
  extern __shared__ unsigned long long s_keys[];  // k_tot of the level
  __shared__ int s_hist[kBins];
  __shared__ int s_count[3];  // n_ini, n_min, keys gathered
  __shared__ unsigned long long s_prefix;
  __shared__ int s_krem, s_done;

  const int g = blockIdx.x;
  int l = 0;
  while (l + 1 < L && g >= t.first_cell[l + 1]) ++l;
  const int c = g - t.first_cell[l];
  const int cols = t.cols[l], ch = t.cell_h[l], cw = t.cell_w[l];
  const int cr = c / cols, cc = c - cr * cols;
  const int y0 = cr * ch, x0 = cc * cw;  // region coordinates
  const int RW = cols * cw;
  // the cell's pixels inside the level; the rest of it reads 0
  const int yl = max(0, min(ch, t.h[l] - border - y0));
  const int xl = max(0, min(cw, t.w[l] - border - x0));
  const int n_px = yl * xl;
  const float* plane = canvas + static_cast<size_t>(l) * H * W +
                       static_cast<size_t>(border + y0) * W + border + x0;
  const int tid = threadIdx.x, lane = lane_id();

  if (tid < 3) s_count[tid] = 0;
  __syncthreads();
  int n_ini = 0, n_min = 0;
  for (int i = tid; i < n_px; i += blockDim.x) {
    const int yy = i / xl;
    const float v = plane[static_cast<size_t>(yy) * W + (i - yy * xl)];
    n_ini += v > th_ini;
    n_min += v > th_min;
  }
  n_ini = warp_sum(n_ini);
  n_min = warp_sum(n_min);
  if (lane == 0) {
    atomicAdd(&s_count[0], n_ini);
    atomicAdd(&s_count[1], n_min);
  }
  __syncthreads();
  // threshold fallback (src/ORBextractor.cc:607-614)
  const bool low = s_count[0] <= 3;
  const float th = low ? th_min : th_ini;
  const int avail = low ? s_count[1] : s_count[0];
  const int k_tot = t.k_tot[l];
  const int k = min(avail, k_tot);

  // the k-th largest key of the cell; 0 takes every candidate
  unsigned long long T = 0;
  if (avail > k_tot && k > 0) {
    unsigned long long prefix = 0;
    int k_rem = k;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int b = tid; b < kBins; b += blockDim.x) s_hist[b] = 0;
      __syncthreads();
      const unsigned long long high =
          shift == 56 ? 0ull : (~0ull << (shift + 8));
      for (int i = tid; i < n_px; i += blockDim.x) {
        const int yy = i / xl, xx = i - yy * xl;
        const float v = plane[static_cast<size_t>(yy) * W + xx];
        if (v > th) {
          const unsigned long long key =
              pixel_key(v, static_cast<unsigned>((y0 + yy) * RW + x0 + xx));
          if ((key & high) == prefix)
            atomicAdd(&s_hist[static_cast<int>(key >> shift) & (kBins - 1)], 1);
        }
      }
      __syncthreads();
      if (tid < 32) pick_digit(s_hist, shift, prefix, k_rem, &s_prefix, &s_krem,
                               &s_done);
      __syncthreads();
      prefix = s_prefix;
      k_rem = s_krem;
      if (s_done) break;
    }
    T = prefix;
  }

  if (tid == 0) info[g] = CellInfo{k, avail, low ? 1 : 0};
  if (k == 0) return;
  // gather the keys >= T (exactly k), one shared counter per warp step
  for (int i0 = 0; i0 < n_px; i0 += blockDim.x) {
    const int i = i0 + tid;
    bool take = false;
    unsigned long long key = 0;
    if (i < n_px) {
      const int yy = i / xl, xx = i - yy * xl;
      const float v = plane[static_cast<size_t>(yy) * W + xx];
      key = pixel_key(v, static_cast<unsigned>((y0 + yy) * RW + x0 + xx));
      take = v > th && key >= T;
    }
    const unsigned m = __ballot_sync(kFull, take);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&s_count[2], __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (take) s_keys[base + __popc(m & ((1u << lane) - 1))] = key;
  }
  __syncthreads();

  // the list, descending: each key's place is the number of larger keys
  unsigned long long* out =
      keys + t.first_key[l] + static_cast<size_t>(c) * k_tot;
  for (int i = tid; i < k; i += blockDim.x) {
    const unsigned long long key = s_keys[i];
    int r = 0;
    for (int j = 0; j < k; ++j) r += s_keys[j] > key;
    out[r] = key;
  }
}

// Exclusive prefix of `pred` over the block, and the block's total.
__device__ int block_scan(bool pred, int* s_warp, int* s_total) {
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned b = __ballot_sync(kFull, pred);
  if (lane == 0) s_warp[warp] = __popc(b);
  __syncthreads();
  if (warp == 0) {
    const int v = lane < n_warps ? s_warp[lane] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += n;
    }
    if (lane < n_warps) s_warp[lane] = incl - v;
    if (lane == 31) *s_total = incl;
  }
  __syncthreads();
  const int r = s_warp[warp] + __popc(b & ((1u << lane) - 1));
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kLevelThreads)
keypoint_select_level_kernel(const float* __restrict__ canvas, LevelTable t,
                             int H, int W, int border, float th_ini,
                             float th_min,
                             const unsigned long long* __restrict__ keys,
                             const CellInfo* __restrict__ info, int Q,
                             int* __restrict__ xy, float* __restrict__ score,
                             unsigned char* __restrict__ valid) {
  extern __shared__ unsigned long long s_dyn[];
  __shared__ int s_hist[kBins];
  __shared__ int s_warp[32];
  __shared__ int s_sum[4];  // candidates over the level; sums of p, r, z
  __shared__ int s_total;
  __shared__ unsigned long long s_prefix;
  __shared__ int s_krem, s_done;

  const int l = blockIdx.x;
  const int cols = t.cols[l], ch = t.cell_h[l], cw = t.cell_w[l];
  const int n = t.rows[l] * cols;
  const int k_tot = t.k_tot[l], quota = t.quota[l];
  const int RW = cols * cw;
  const int g0 = t.first_cell[l];
  const unsigned long long* lkeys = keys + t.first_key[l];
  const int tid = threadIdx.x, lane = lane_id(), warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // per level: k_tot retained keys, their flat indices, then 9 ints a cell
  unsigned long long* s_fkey = s_dyn;
  int* s_flat = reinterpret_cast<int*>(s_fkey + k_tot);
  int* s_cnt = s_flat + k_tot;
  int* s_avail = s_cnt + n;
  int* s_low = s_avail + n;
  int* s_p = s_low + n;      // pool entries of the cell
  int* s_r = s_p + n;        // retained: min(p, retain)
  int* s_nm = s_r + n;       // the redistribution's no_more flags
  int* s_poff = s_nm + n;    // first pool position of the cell
  int* s_roff = s_poff + n;  // first retained entry of the cell
  int* s_zoff = s_roff + n;  // first of the cell's p - r zeroed entries

  if (tid < 4) s_sum[tid] = 0;
  __syncthreads();
  int pos_part = 0;
  for (int c = tid; c < n; c += blockDim.x) {
    const CellInfo ci = info[g0 + c];
    s_cnt[c] = ci.count;
    s_avail[c] = ci.avail;
    s_low[c] = ci.low_th;
    pos_part += ci.avail;
  }
  pos_part = warp_sum(pos_part);
  if (lane == 0) atomicAdd(&s_sum[0], pos_part);
  __syncthreads();
  const int n_pos = s_sum[0];

  // the pool: every candidate, or the keys >= the level's k_tot-th key
  unsigned long long T = 0;
  const bool cut = n_pos > k_tot && k_tot > 0;
  if (cut) {
    unsigned long long prefix = 0;
    int k_rem = k_tot;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int b = tid; b < kBins; b += blockDim.x) s_hist[b] = 0;
      __syncthreads();
      const unsigned long long high =
          shift == 56 ? 0ull : (~0ull << (shift + 8));
      for (int c = warp; c < n; c += n_warps) {
        const unsigned long long* list = lkeys + static_cast<size_t>(c) * k_tot;
        for (int r = lane; r < s_cnt[c]; r += 32) {
          const unsigned long long key = list[r];
          if ((key & high) == prefix)
            atomicAdd(&s_hist[static_cast<int>(key >> shift) & (kBins - 1)], 1);
        }
      }
      __syncthreads();
      if (tid < 32) pick_digit(s_hist, shift, prefix, k_rem, &s_prefix, &s_krem,
                               &s_done);
      __syncthreads();
      prefix = s_prefix;
      k_rem = s_krem;
      if (s_done) break;
    }
    T = prefix;
  }
  for (int c = warp; c < n; c += n_warps) {
    int p = s_cnt[c];
    if (cut) {
      // the list is descending: its pool entries are the keys >= T
      const unsigned long long* list = lkeys + static_cast<size_t>(c) * k_tot;
      p = 0;
      for (int r0 = 0; r0 < s_cnt[c]; r0 += 32) {
        const int r = r0 + lane;
        p += __popc(__ballot_sync(kFull, r < s_cnt[c] && list[r] >= T));
      }
    }
    if (lane == 0) s_p[c] = p;
  }
  __syncthreads();

  // the redistribution (reference_quota, src/ORBextractor.cc:644-670) and
  // the prefix sums of p, r and p - r over the cells, by warp 0
  if (warp == 0) {
    const int fair = (quota + n - 1) / n;
    int d = 0, n_nm = 0;
    for (int c = lane; c < n; c += 32) {
      const int nm = s_avail[c] <= fair;
      s_nm[c] = nm;
      d += nm ? fair - s_avail[c] : 0;
      n_nm += nm;
    }
    d = warp_sum(d);
    n_nm = warp_sum(n_nm);
    int q = fair;
    for (;;) {
      const int u = max(n - n_nm, 1);
      if (d > 0) q = fair + (d + u - 1) / u;
      int dn = 0, newly = 0;
      for (int c = lane; c < n; c += 32) {
        if (!s_nm[c] && s_avail[c] <= q) {
          s_nm[c] = 1;
          dn += q - s_avail[c];
          ++newly;
        }
      }
      d = warp_sum(dn);
      newly = warp_sum(newly);
      if (!newly) break;  // a fixed point: later passes change nothing
      n_nm += newly;
    }
    int carry_p = 0, carry_r = 0, carry_z = 0;
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int c = c0 + lane;
      int p = 0, r = 0;
      if (c < n) {
        p = s_p[c];
        r = min(p, s_nm[c] ? s_avail[c] : q);
      }
      int ip = p, ir = r, iz = p - r;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int np = __shfl_up_sync(kFull, ip, o);
        const int nr = __shfl_up_sync(kFull, ir, o);
        const int nz = __shfl_up_sync(kFull, iz, o);
        if (lane >= o) {
          ip += np;
          ir += nr;
          iz += nz;
        }
      }
      if (c < n) {
        s_r[c] = r;
        s_poff[c] = carry_p + ip - p;
        s_roff[c] = carry_r + ir - r;
        s_zoff[c] = carry_z + iz - (p - r);
      }
      carry_p += __shfl_sync(kFull, ip, 31);
      carry_r += __shfl_sync(kFull, ir, 31);
      carry_z += __shfl_sync(kFull, iz, 31);
    }
    if (lane == 0) {
      s_sum[1] = carry_p;
      s_sum[2] = carry_r;
      s_sum[3] = carry_z;
    }
  }
  __syncthreads();
  const int n_pool = s_sum[1], R = s_sum[2], Z = s_sum[3];

  // the retained entries, keyed by (score, pool position)
  for (int c = warp; c < n; c += n_warps) {
    const unsigned long long* list = lkeys + static_cast<size_t>(c) * k_tot;
    for (int r = lane; r < s_r[c]; r += 32) {
      const unsigned long long key = list[r];
      const unsigned pos = static_cast<unsigned>(s_poff[c] + r);
      s_fkey[s_roff[c] + r] = (key & 0xffffffff00000000ull) | (0xffffffffu - pos);
      s_flat[s_roff[c] + r] = static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
    }
  }
  __syncthreads();

  int* out_xy = xy + static_cast<size_t>(l) * Q * 2;
  float* out_score = score + static_cast<size_t>(l) * Q;
  unsigned char* out_valid = valid + static_cast<size_t>(l) * Q;
  auto put = [&](int slot, int flat, float s) {
    out_xy[2 * slot] = flat < 0 ? 0 : flat % RW + border;
    out_xy[2 * slot + 1] = flat < 0 ? 0 : flat / RW + border;
    out_score[slot] = s;
    out_valid[slot] = s > 0.0f && slot < quota;
  };
  // retainBest: a retained entry's slot is the number of larger keys
  for (int i = tid; i < R; i += blockDim.x) {
    const unsigned long long key = s_fkey[i];
    int slot = 0;
    for (int j = 0; j < R; ++j) slot += s_fkey[j] > key;
    if (slot < Q) put(slot, s_flat[i], __uint_as_float(static_cast<unsigned>(key >> 32)));
  }
  // then the pool's zeros in pool order: the entries past each cell's
  // retained count, the zero pixels that filled the pool, the padding
  for (int j = tid; j < Z && R + j < Q; j += blockDim.x) {
    int lo = 0, hi = n - 1;  // the last cell whose first zeroed entry is <= j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_zoff[mid] <= j) lo = mid;
      else hi = mid - 1;
    }
    const unsigned long long key =
        lkeys[static_cast<size_t>(lo) * k_tot + s_r[lo] + j - s_zoff[lo]];
    put(R + j, static_cast<int>(0xffffffffu - static_cast<unsigned>(key)), 0.0f);
  }
  // the pool's zero pixels: the first k_tot - n_pool by flat index, all
  // among the first k_tot flat indices
  const int need = min(k_tot - n_pool, Q - R - Z);
  int found = 0;
  for (int f0 = 0; f0 < k_tot && found < need; f0 += blockDim.x) {
    const int f = f0 + tid;
    bool zero = false;
    if (f < k_tot) {
      const int y = f / RW, x = f - y * RW;
      float v = 0.0f;
      if (border + y < t.h[l] && border + x < t.w[l])
        v = canvas[(static_cast<size_t>(l) * H + border + y) * W + border + x];
      zero = !(v > (s_low[(y / ch) * cols + x / cw] ? th_min : th_ini));
    }
    const int zi = found + block_scan(zero, s_warp, &s_total);
    if (zero && zi < need) put(R + Z + zi, f, 0.0f);
    found += s_total;
    __syncthreads();
  }
  for (int slot = max(k_tot, R) + tid; slot < Q; slot += blockDim.x)
    put(slot, -1, 0.0f);
}

}  // namespace

// table: L rows of (h, w, rows, cols, cellH, cellW, k_tot, quota, first
// cell, first key slot), host memory; keys: n_keys = sum of cells x k_tot
// 64-bit slots; info: 3 ints per cell; outputs xy [L, Q, 2] int32, score
// [L, Q] float, valid [L, Q] bool.
extern "C" int keypoint_select(const void* canvas, const void* table, int L,
                               int H, int W, int border, float th_ini,
                               float th_min, int n_cells, int Q,
                               int cell_smem, int level_smem, void* keys,
                               void* info, void* xy, void* score, void* valid,
                               void* stream) {
  if (L < 1 || L > kMaxLevels || H < 1 || W < 1 || n_cells < 1 || Q < 1 ||
      border < 0)
    return cudaErrorInvalidValue;
  LevelTable t{};
  const int* rows = static_cast<const int*>(table);
  for (int l = 0; l < L; ++l) {
    const int* r = rows + 10 * l;
    t.h[l] = r[0];
    t.w[l] = r[1];
    t.rows[l] = r[2];
    t.cols[l] = r[3];
    t.cell_h[l] = r[4];
    t.cell_w[l] = r[5];
    t.k_tot[l] = r[6];
    t.quota[l] = r[7];
    t.first_cell[l] = r[8];
    t.first_key[l] = r[9];
    if (r[2] < 1 || r[3] < 1 || r[4] < 1 || r[5] < 1 || r[0] > H || r[1] > W)
      return cudaErrorInvalidValue;
  }
  t.first_cell[L] = n_cells;
  cudaError_t err = cudaSuccess;
  if (cell_smem > 48 * 1024)
    err = cudaFuncSetAttribute(keypoint_select_cells_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cell_smem);
  if (err == cudaSuccess && level_smem > 48 * 1024)
    err = cudaFuncSetAttribute(keypoint_select_level_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               level_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  keypoint_select_cells_kernel<<<n_cells, kCellThreads, cell_smem, s>>>(
      static_cast<const float*>(canvas), t, L, H, W, border, th_ini, th_min,
      static_cast<unsigned long long*>(keys), static_cast<CellInfo*>(info));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  keypoint_select_level_kernel<<<L, kLevelThreads, level_smem, s>>>(
      static_cast<const float*>(canvas), t, H, W, border, th_ini, th_min,
      static_cast<const unsigned long long*>(keys),
      static_cast<const CellInfo*>(info), Q, static_cast<int*>(xy),
      static_cast<float*>(score), static_cast<unsigned char*>(valid));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
