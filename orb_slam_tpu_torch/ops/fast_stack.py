"""Level-stacked pyramid, FAST detectors and keypoint selection.

Port of orb_slam_tpu/ops/fast_stack.py: `_bilinear_matrix` and
`pyramid_matrices` (:25-57), `build_pyramid_stack` (:60-96), the three
detector entries and their shared selection tail:
  - `detect_keypoints_packed`, the port of `detect_keypoints_stack_pallas`
    (:169-192): kernel K1 (ops/fast_score_nms.py), then the selection;
    the FAST (nScoreType=1) extraction;
  - `detect_keypoints_stack` (:126-164): kernel K3
    (ops/fast_score_rect.py), the Harris ranking when asked, then
    `select_from_scores` (:264-292); the Harris (nScoreType=0) extraction;
  - `DetectCellsFused`, the port of `_detect_cells_fused` (:195-261):
    kernel K4 (ops/fast_cell_topk.py) and its candidate tail;
  - `KeypointSelector`, the port of `_select_from_masked` (:295-408):
    kernel K5 (ops/keypoint_select.py) on the card, its plain version on
    the CPU.
The FAST score `fast_score_stack` (:99-123) is in ops/fast.py.

All levels live in one [L, H, W] canvas, each in its top-left corner.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.ops.fast import (
    harris_rank, harris_score_map, level_interior, reference_grid,
    reference_quota,
)
from orb_slam_tpu_torch.ops.fast_cell_topk import cell_block_table, fast_cell_topk
from orb_slam_tpu_torch.ops.fast_score_nms import fast_score_nms
from orb_slam_tpu_torch.ops.fast_score_rect import fast_score_nms_rect
from orb_slam_tpu_torch.ops.image import pyramid_shapes
from orb_slam_tpu_torch.ops.keypoint_select import LaunchPlan, keypoint_select
from orb_slam_tpu_torch.ops.sort import top_k


def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix (half-pixel centres)."""
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    w1 = np.clip(src - i0, 0.0, 1.0)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), i0] += 1.0 - w1
    M[np.arange(n_out), i1] += w1
    return M


def pyramid_matrices(height: int, width: int, n_levels: int,
                     scale_factor: float):
    """Zero-padded level-0 -> level-l bilinear matrices, numpy f32:
    Rp [L-1, H, H] and Cp [L-1, W, W] (each level resamples level 0
    directly through the composed per-step interpolations)."""
    shapes = pyramid_shapes(height, width, n_levels, scale_factor)
    Rs = [np.eye(height, dtype=np.float32)]
    Cs = [np.eye(width, dtype=np.float32)]
    for lvl in range(1, n_levels):
        h0, w0 = shapes[lvl - 1]
        h1, w1 = shapes[lvl]
        Rs.append(_bilinear_matrix(h0, h1) @ Rs[-1])
        Cs.append(_bilinear_matrix(w0, w1) @ Cs[-1])
    Rp = np.zeros((n_levels - 1, height, height), np.float32)
    Cp = np.zeros((n_levels - 1, width, width), np.float32)
    for lvl in range(1, n_levels):
        Rp[lvl - 1, :Rs[lvl].shape[0]] = Rs[lvl]
        Cp[lvl - 1, :Cs[lvl].shape[0]] = Cs[lvl]
    return Rp, Cp


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and return float32 (the value a bf16 operand has)."""
    return x.to(torch.bfloat16).to(torch.float32)


def build_pyramid_stack(img: torch.Tensor, Rp: torch.Tensor,
                        Cp: torch.Tensor) -> torch.Tensor:
    """[H, W] f32 image -> [L, H, W] f32 canvas.

    Mirrors the JAX bf16 points exactly: levels >= 1 are
    bf16(bf16(Rp) @ bf16(img)) @ bf16(Cp)^T with f32 products and sums. The
    products of bf16 values are exact in f32, so only the summation order
    can differ from XLA's, which may flip a rare bf16 rounding of `rows`.
    (bf16 values are exact in TF32 as well, so the TF32 setting does not
    change these products.) Level 0 is the image itself, bit for bit."""
    rows = _bf16(Rp) @ _bf16(img)                        # [L-1, H, W]
    rest = _bf16(rows) @ _bf16(Cp).transpose(1, 2)       # [L-1, H, W]
    return torch.cat([img[None], rest], 0)


class KeypointSelector(torch.nn.Module):
    """Per-cell threshold fallback, quota redistribution and retainBest on a
    masked score canvas (non-maxima and out-of-border pixels already 0):
    the port of `_select_from_masked`.

    The static grid of every level is fixed at construction; the small
    per-level tables are buffers, so a call copies nothing from the host.
    A call returns (xy [L, Qmax, 2] int32 level-local (x, y), score
    [L, Qmax] f32, valid [L, Qmax] bool), Qmax = max(quotas). It reproduces
    the JAX selection exactly, tie order included: its approx_max_k pool
    (exact off the TPU), its stable lexicographic (cell, -score) sort and
    its lax.top_k. On a CUDA canvas the call is kernel K5
    (ops/keypoint_select.py), on a CPU canvas `plain`."""

    def __init__(self, shapes, quotas, th_ini=20.0, th_min=7.0, border=16,
                 device="cuda"):
        super().__init__()
        self.shapes = [tuple(s) for s in shapes]
        self.quotas = list(quotas)
        self.th_ini, self.th_min, self.border = th_ini, th_min, border
        ratio = shapes[0][1] / shapes[0][0]   # the reference's imageRatio
        self.grids = [reference_grid(h, w, q, ratio, border)
                      for (h, w), q in zip(shapes, quotas)]
        self.k_tots = [int(min(rows * cellH * cols * cellW, 2 * q))
                       for (rows, cols, cellH, cellW), q in zip(self.grids,
                                                                quotas)]
        n_real = torch.tensor([r * c for r, c, _, _ in self.grids])
        C = int(n_real.max())
        self.register_buffer("quota_t", torch.tensor(quotas, dtype=torch.int32))
        self.register_buffer("active", torch.arange(C)[None, :] < n_real[:, None])
        self._plan = None
        self.to(require_device(device))

    def launch_plan(self) -> LaunchPlan:
        """K5's level table for this selector, made at the first launch."""
        if self._plan is None:
            self._plan = LaunchPlan(self)
        return self._plan

    def forward(self, base: torch.Tensor):
        return keypoint_select(base, self)

    def plain(self, base: torch.Tensor):
        """The selection in plain PyTorch: K5's plain version."""
        L, H, W = base.shape
        dev, border = base.device, self.border
        base = base.clone()
        for l, (h, w) in enumerate(self.shapes):   # canvas outside the level
            base[l, h:] = 0.0
            base[l, :, w:] = 0.0

        P, C = max(self.k_tots), self.active.shape[1]
        vals, pxs, pys, cellids, ranks, avails = [], [], [], [], [], []
        for l, ((rows, cols, cellH, cellW), k_tot) in enumerate(
                zip(self.grids, self.k_tots)):
            RH, RW = rows * cellH, cols * cellW
            region = base[l, border:min(border + RH, H),
                          border:min(border + RW, W)]
            region = F.pad(region, (0, RW - region.shape[1],
                                    0, RH - region.shape[0]))
            cells4 = region.reshape(rows, cellH, cols, cellW)
            # threshold fallback: retry a cell at th_min when FAST at th_ini
            # yields <= 3 corners (src/ORBextractor.cc:607-614)
            n_ini = (cells4 > self.th_ini).sum((1, 3))
            cell_th = torch.where(n_ini > 3, self.th_ini, self.th_min)
            masked4 = torch.where(cells4 > cell_th[:, None, :, None], cells4, 0.0)
            avail = (masked4 > 0.0).sum((1, 3), dtype=torch.int32)
            val, idx = top_k(masked4.reshape(RH * RW), k_tot)
            y = idx // RW
            x = idx % RW
            ci = (y // cellH) * cols + x // cellW
            ci = torch.where(val > 0.0, ci, rows * cols)  # empty slots last
            # cell-major, score-descending within a cell: `val` is already
            # score-descending with ties by index, so one stable sort by cell
            # is the JAX lexicographic sort
            ci, order = torch.sort(ci, stable=True)
            val, x, y = val[order], x[order], y[order]
            ar = torch.arange(k_tot, device=dev)
            first = torch.ones(k_tot, dtype=torch.bool, device=dev)
            first[1:] = ci[1:] != ci[:-1]
            rank = ar - torch.cummax(torch.where(first, ar, 0), 0).values
            pad = P - k_tot
            vals.append(F.pad(val, (0, pad)))
            pxs.append(F.pad(x + border, (0, pad)))
            pys.append(F.pad(y + border, (0, pad)))
            cellids.append(F.pad(torch.clamp(ci, max=rows * cols - 1), (0, pad)))
            ranks.append(F.pad(rank, (0, pad), value=P))
            avails.append(F.pad(avail.reshape(-1), (0, C - rows * cols)))

        # one batched redistribution over all levels (padding cells inactive)
        retain = reference_quota(torch.stack(avails), self.quota_t, self.active)
        pool = torch.stack(vals)
        cid = torch.stack(cellids)
        pool = torch.where(torch.stack(ranks) < torch.gather(retain, 1, cid),
                           pool, 0.0)
        top_score, sel = top_k(pool, max(self.quotas))   # retainBest
        xy = torch.stack([torch.gather(torch.stack(pxs), 1, sel),
                          torch.gather(torch.stack(pys), 1, sel)],
                         -1).to(torch.int32)
        slot = torch.arange(sel.shape[1], device=dev)[None, :]
        valid = (top_score > 0.0) & (slot < self.quota_t[:, None])
        return xy, top_score, valid


def detect_keypoints_packed(stack: torch.Tensor, selector: KeypointSelector):
    """K1 (score + NMS + border mask) then the selection tail: the port of
    detect_keypoints_stack_pallas (fast_stack.py:169-192)."""
    base = fast_score_nms(stack, selector.shapes, border=selector.border)
    return selector(base)


def level_masked(score: torch.Tensor, keep: torch.Tensor,
                 selector: KeypointSelector) -> torch.Tensor:
    """`score` with non-maxima and pixels outside each level's
    [border, h-border) x [border, w-border) zeroed: the canvas the
    selection takes."""
    L, H, W = score.shape
    in_border = level_interior(selector.shapes, H, W, selector.border,
                               score.device)
    return torch.where(keep & in_border, score, 0.0)


def select_from_scores(score: torch.Tensor, keep: torch.Tensor,
                       selector: KeypointSelector):
    """Zero non-maxima and pixels outside each level's border, then select
    (fast_stack.py:264-292)."""
    return selector(level_masked(score, keep, selector))


def detect_keypoints_stack(stack: torch.Tensor, selector: KeypointSelector,
                           use_harris: bool = False):
    """K3 (FAST score + NMS over the whole canvas), then, with `use_harris`,
    the nScoreType=0 ranking by the Harris response of every level plane
    (its minimum taken over the whole canvas, padding included, as the JAX
    vmap + min), then the selection: the port of detect_keypoints_stack
    (fast_stack.py:126-164). Returns (xy [L, Qmax, 2] int32, score
    [L, Qmax], valid [L, Qmax])."""
    score, keep = fast_score_nms_rect(stack)
    if use_harris:
        score, keep = harris_rank(score, keep, harris_score_map(stack),
                                  selector.th_ini, selector.th_min)
    return select_from_scores(score, keep, selector)


class DetectCellsFused(torch.nn.Module):
    """The cell-fused detector, the port of `_detect_cells_fused`
    (fast_stack.py:195-261): K4's per-cell top-K candidates (32x32 cells in
    32x256 strips), the per-cell two-tier threshold (th_ini, th_min
    fallback on <= 3 corners) on those candidates, the reference quota
    redistribution and a per-level top_k.

    The host tail is the JAX one as written, divergences included: `avail`
    is the count of a cell's thresholded top-K candidates (so it saturates
    at K), `n_ini` comes from the same candidates, padding rows of a level
    are inactive, and the last pick is ops/sort.top_k, the tie order of
    lax.top_k. On texture-skewed frames it therefore selects differently
    from `detect_keypoints_stack` (fast_stack.py:200-205, :239-243).

    The per-level gather table, `active`, the rank tile and the quotas are
    buffers built once, so a call copies nothing from the host. A call on
    the [L, H, W] canvas returns (xy [L, Qmax, 2] int32 level-local (x, y),
    score [L, Qmax] f32, valid [L, Qmax] bool), the shapes of
    `detect_keypoints_stack`."""

    BH, BW = 32, 256

    def __init__(self, shapes, quotas, K: int = 4, th_ini: float = 20.0,
                 th_min: float = 7.0, border: int = 16, device="cuda"):
        super().__init__()
        self.shapes = [tuple(s) for s in shapes]
        self.quotas = list(quotas)
        self.K, self.th_ini, self.th_min, self.border = K, th_ini, th_min, border
        lvl, _, _ = cell_block_table(self.shapes, self.BH, self.BW, border)
        L, nc = len(self.shapes), self.BW // self.BH
        counts = [lvl.count(l) for l in range(L)]
        starts = np.cumsum([0] + counts)
        max_b = max(counts)
        # block index of each (level, row slot); slots past a level's count
        # read a zero row appended after the last block
        gather = np.full((L, max_b), len(lvl), np.int64)
        for l in range(L):
            gather[l, :counts[l]] = np.arange(starts[l], starts[l + 1])
        n_cells = max_b * nc
        n_real = torch.tensor([c * nc for c in counts])
        self.register_buffer("gather", torch.from_numpy(gather))
        self.register_buffer("active", torch.arange(n_cells)[None, :] < n_real[:, None])
        self.register_buffer("rank", torch.arange(K).repeat(n_cells)[None, :])
        self.register_buffer("quota_t", torch.tensor(quotas, dtype=torch.int32))
        self.to(require_device(device))

    def forward(self, stack: torch.Tensor):
        L, K = len(self.shapes), self.K
        vals, pos = fast_cell_topk(stack, self.shapes, K=K, BH=self.BH,
                                   BW=self.BW, border=self.border)
        # <=3-corner fallback (src/ORBextractor.cc:607-614) per cell, on its
        # score-sorted candidates
        n_ini = (vals > self.th_ini).sum(2, keepdim=True)
        th = torch.where(n_ini > 3, self.th_ini, self.th_min)
        vals = torch.where(vals > th, vals, 0.0)
        # [n_blocks + 1, ...] with a zero row for the padding slots
        vals = torch.cat([vals, torch.zeros_like(vals[:1])])
        pos = torch.cat([pos, torch.zeros_like(pos[:1])])
        Vm = vals[self.gather].reshape(L, -1)            # [L, row_len]
        Pm = pos[self.gather].reshape(L, -1)
        avail = (Vm.reshape(L, -1, K) > 0.0).sum(2, dtype=torch.int32)
        retain = reference_quota(avail, self.quota_t, self.active)
        retain_k = retain[:, :, None].expand(-1, -1, K).reshape(L, -1)
        key = torch.where(self.rank < retain_k, Vm, 0.0)
        top_score, sel = top_k(key, max(self.quotas))
        psel = torch.gather(Pm, 1, sel)
        xy = torch.stack([psel % 65536, psel // 65536], -1).to(torch.int32)
        slot = torch.arange(sel.shape[1], device=stack.device)[None, :]
        valid = (top_score > 0.0) & (slot < self.quota_t[:, None])
        return xy, top_score, valid
