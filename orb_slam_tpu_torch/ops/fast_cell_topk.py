"""Kernel K4: FAST score + 3x3 NMS + border mask + per-cell top-K candidates.

Port of the Pallas kernel `fast_cell_topk_packed` / `_make_cell_topk_kernel`
(orb_slam_tpu/ops/pallas_fast.py:287-427) and of its block table
`cell_block_table` (:271-284). The CUDA kernel is csrc/fast_cell_topk.cu;
`fast_cell_topk_plain` is the same function in plain PyTorch. Its one
caller is the cell-fused detector (ops/fast_stack.py::DetectCellsFused).

Both return (vals [n_blocks, BW//BH, K] f32, pos [n_blocks, BW//BH, K]
int32): for each strip of the table (BH rows x BW columns of one level,
cut into BH x BH cells), the K rounds of "take the cell's maximum, report
the smallest packed position y*65536 + x holding it (if > 0, else 2^30),
zero that one pixel" on the masked FAST score (pallas_fast.py:355-366).
The values are exact, so the kernel is bit-equal to the plain version.
The kernel runs one block per cell and skips the stencil on the cells
that `empty_cells` lists, whose output the shapes alone decide.

`fast_cell_topk` launches the kernel for a CUDA tensor and runs the plain
version only for a CPU tensor. Neither copies from the host once its
tables are built (once per configuration), so both capture in a CUDA
graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from orb_slam_tpu_torch._build import CudaKernel
from orb_slam_tpu_torch.ops.fast import fast_score_stack

MAX_LEVELS = 32   # kMaxLevels in csrc/fast_cell_topk.cu
SENTINEL = 2 ** 30

KERNEL = CudaKernel(
    "fast_cell_topk.cu", "fast_cell_topk",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def cell_block_table(shapes, BH: int, BW: int, border: int):
    """(level, r0, c0) lists of the strips that meet each level's
    detectable interior [border, h-border) x [border, w-border)."""
    lvl, r0s, c0s = [], [], []
    for l, (h, w) in enumerate(shapes):
        for r in range(0, h - border, BH):
            if r + BH <= border:
                continue
            for c in range(0, w - border, BW):
                lvl.append(l)
                r0s.append(r)
                c0s.append(c)
    return lvl, r0s, c0s


@functools.lru_cache(maxsize=64)
def _strip_table(shapes: tuple, BH: int, BW: int, border: int, device):
    """Per-strip (level, r0, c0, h, w) as int64 tensors on `device`, made
    once per configuration, so that the plain version copies nothing from
    the host and captures in a CUDA graph."""
    lvl, r0s, c0s = cell_block_table(shapes, BH, BW, border)
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return (as_t(lvl), as_t(r0s), as_t(c0s), as_t([shapes[l][0] for l in lvl]),
            as_t([shapes[l][1] for l in lvl]))


def masked_strips(stack: torch.Tensor, shapes, BH: int = 32, BW: int = 256,
                  border: int = 16):
    """(s, y, x), each [n_blocks, BH, BW]: the masked FAST score of every
    strip of the table (the score where the pixel is a 3x3 maximum inside
    its level's [border, h-border) x [border, w-border), else +0.0) and
    the canvas row and column of each strip pixel."""
    L, H, W = stack.shape
    dev = stack.device
    lvl_t, r0, c0, hs, ws = _strip_table(tuple(map(tuple, shapes)), BH, BW,
                                         border, dev)
    # each strip's window: canvas rows r0-4 .. r0+BH+3, cols c0-4 .. c0+BW+3,
    # clamped to the canvas (the Pallas wrapper's mode="edge" pad)
    rows = (r0[:, None] - 4 + torch.arange(BH + 8, device=dev)).clamp(0, H - 1)
    cols = (c0[:, None] - 4 + torch.arange(BW + 8, device=dev)).clamp(0, W - 1)
    win = stack[lvl_t[:, None, None], rows[:, :, None], cols[:, None, :]]
    score = fast_score_stack(win)[:, 3:BH + 5, 3:BW + 5]   # [nb, BH+2, BW+2]
    mx = F.max_pool2d(score[:, None], 3, stride=1)[:, 0]   # [nb, BH, BW]
    center = score[:, 1:BH + 1, 1:BW + 1]
    y = r0[:, None, None] + torch.arange(BH, device=dev)[None, :, None]
    x = c0[:, None, None] + torch.arange(BW, device=dev)[None, None, :]
    inb = ((y >= border) & (y < hs[:, None, None] - border)
           & (x >= border) & (x < ws[:, None, None] - border))
    return torch.where((center >= mx) & inb, center, 0.0), y, x


def fast_cell_topk_plain(stack: torch.Tensor, shapes, K: int = 4, BH: int = 32,
                         BW: int = 256, border: int = 16):
    """Plain PyTorch K4 on the [L, H, W] f32 canvas."""
    s, y, x = masked_strips(stack, shapes, BH, BW, border)
    nb, nc = s.shape[0], BW // BH
    # per cell, in row-major (y, x_in) order: [nb, cell, BH*BH]
    work = s.reshape(nb, BH, nc, BH).permute(0, 2, 1, 3).reshape(nb, nc, BH * BH)
    enc = ((y * 65536 + x).reshape(nb, BH, nc, BH).permute(0, 2, 1, 3)
           .reshape(nb, nc, BH * BH))
    vals, poss = [], []
    for _ in range(K):
        mk = work.amax(-1)
        eq = (work == mk[..., None]) & (work > 0.0)
        pk = torch.where(eq, enc, SENTINEL).amin(-1)
        work = torch.where(enc == pk[..., None], 0.0, work)
        vals.append(mk)
        poss.append(pk)
    return torch.stack(vals, -1), torch.stack(poss, -1).to(torch.int32)


def empty_cells(shapes, BH: int = 32, BW: int = 256, border: int = 16):
    """[n_blocks, BW//BH] bool: the cells of the table with no pixel in their
    level's [border, h-border) x [border, w-border). The kernel writes value
    +0.0 and position 2^30 in their K slots without scoring them; the rule
    gives exactly that there, since every pixel is masked to +0.0."""
    lvl, r0s, c0s = cell_block_table(shapes, BH, BW, border)
    out = []
    for l, r0, c0 in zip(lvl, r0s, c0s):
        h, w = shapes[l]
        rows_empty = max(r0, border) >= min(r0 + BH, h - border)
        out.append([rows_empty or max(c, border) >= min(c + BH, w - border)
                    for c in range(c0, c0 + BW, BH)])
    return torch.tensor(out, dtype=torch.bool).reshape(len(lvl), BW // BH)


@functools.lru_cache(maxsize=64)
def _level_table(shapes: tuple, BH: int, BW: int, border: int):
    """(number of table entries, the kernel's per-level rows as a ctypes
    array: h, w, first entry, r0 of the first strip row, strips per strip
    row), computed once per configuration so that a launch spends no host
    time on it."""
    lvl, r0s, c0s = cell_block_table(shapes, BH, BW, border)
    rows = []
    for l, (h, w) in enumerate(shapes):
        first = lvl.index(l) if l in lvl else len(lvl)
        n_cols = len({c for c, m in zip(c0s, lvl) if m == l})
        rows += [h, w, first, r0s[first] if l in lvl else 0, n_cols]
    return len(lvl), (ctypes.c_int * len(rows))(*rows)


def fast_cell_topk(stack: torch.Tensor, shapes, K: int = 4, BH: int = 32,
                   BW: int = 256, border: int = 16):
    """K4 on `stack` ([L, H, W] float32, levels in the top-left corner with
    true sizes `shapes`). CUDA tensor: the kernel (BH = 32, BW a multiple of
    32 up to 256); CPU tensor: the plain version."""
    if not stack.is_cuda:
        return fast_cell_topk_plain(stack, shapes, K, BH, BW, border)
    if stack.dtype != torch.float32 or not stack.is_contiguous():
        raise ValueError("fast_cell_topk: stack must be contiguous float32")
    L, H, W = stack.shape
    if len(shapes) != L or L > MAX_LEVELS:
        raise ValueError(f"fast_cell_topk: {len(shapes)} shapes for {L} "
                         f"levels (at most {MAX_LEVELS})")
    if any(h > H or w > W for h, w in shapes):
        raise ValueError("fast_cell_topk: a level exceeds the canvas")
    if BH != 32 or BW % 32 or not 32 <= BW <= 256 or K < 1:
        raise ValueError(f"fast_cell_topk: the kernel takes BH = 32, BW a "
                         f"multiple of 32 up to 256 and K >= 1, not BH={BH}, "
                         f"BW={BW}, K={K}")
    n_blocks, table = _level_table(tuple(map(tuple, shapes)), BH, BW, border)
    if not n_blocks:
        raise ValueError("fast_cell_topk: no level has a detectable interior")
    nb, nc = n_blocks, BW // BH
    vals = torch.empty((nb, nc, K), dtype=torch.float32, device=stack.device)
    pos = torch.empty((nb, nc, K), dtype=torch.int32, device=stack.device)
    with torch.cuda.device(stack.device):
        KERNEL(stack.data_ptr(), vals.data_ptr(), pos.data_ptr(),
               ctypes.cast(table, ctypes.c_void_p), nb, L, H, W, BW, K, border,
               torch.cuda.current_stream().cuda_stream)
    return vals, pos
