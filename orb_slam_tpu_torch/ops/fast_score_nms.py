"""Kernel K1: FAST-9/16 score + 3x3 NMS + border mask over the level canvas.

Port of the packed Pallas kernel `fast_score_nms_packed` /
`_make_packed_kernel` (orb_slam_tpu/ops/pallas_fast.py:121-268) in the
form the main path calls it (fast_stack.py:188: `tree=True, border=16`).
The CUDA kernel is csrc/fast_score_nms.cu; `fast_score_nms_plain` is the
same function in plain PyTorch, built on `ops/fast.py::fast_score_stack`,
the port of the XLA score orb_slam_tpu/ops/fast_stack.py:99-123.

`fast_score_nms` launches the kernel for a CUDA tensor and runs the plain
version only for a CPU tensor. Both return a masked score canvas: the
FAST score where a pixel is a 3x3 maximum inside its level's
[border, h-border) x [border, w-border), else 0. The kernel launches one
block per 32x32 tile that meets a level (`tile_table`) and leaves the
canvas outside those tiles unwritten (as the Pallas kernel does); the
plain version zeroes it; the selection never reads it (K5 reads each
level inside its true size; KeypointSelector.plain zeroes it).

Every output value is a min or max of exactly rounded f32 differences, so
the kernel equals the plain version exactly, whatever order it reduces in.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from orb_slam_tpu_torch._build import CudaKernel
from orb_slam_tpu_torch.ops.fast import fast_score_stack, level_interior

MAX_LEVELS = 32  # kMaxLevels in csrc/fast_score_nms.cu
TILE = 32        # fast::kTile in csrc/fast_tile.cuh

KERNEL = CudaKernel(
    "fast_score_nms.cu", "fast_score_nms",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def fast_score_nms_plain(canvas: torch.Tensor, shapes, border: int = 16):
    """Plain PyTorch K1: [L, H, W] f32 -> [L, H, W] f32 masked score."""
    L, H, W = canvas.shape
    # score on a 1-pixel halo: the canvas edge-padded by 1, then by 3 more
    # inside fast_score_stack, is the Pallas kernel's edge pad of 4
    halo = F.pad(canvas[None], (1, 1, 1, 1), mode="replicate")[0]
    score = fast_score_stack(halo)                       # [L, H+2, W+2]
    mx = F.max_pool2d(score[None], 3, stride=1)[0]       # [L, H, W]
    center = score[:, 1:1 + H, 1:1 + W]
    inner = level_interior(shapes, H, W, border, canvas.device)
    return torch.where((center >= mx) & inner, center, 0.0)


def tile_table(shapes):
    """(number of blocks, the kernel's rows: (h, w) of each level, then
    (level, first block, r0 of the first tile row, tiles per tile row) of
    each of 3L segments) for the TILE x TILE tiles that meet a level.

    Each segment is a run of whole tile rows of one level, row-major. The
    segments come in three groups, one segment per level in each: the inner
    tile rows of every level, then every level's top tile row, then every
    level's bottom tile row. A tile scores only the rows that the border
    mask leaves in play (csrc/fast_tile.cuh), so the top and bottom tile
    rows cost about half a tile or less: dispatched last, they fill the end
    of the launch, where SMs would otherwise wait for the last full tiles.
    Block b lies in the last segment whose first block is <= b."""
    n_ty = [-(-h // TILE) for h, _ in shapes]
    n_tx = [-(-w // TILE) for _, w in shapes]
    inner = [(l, 1, max(n - 2, 0)) for l, n in enumerate(n_ty)]
    top = [(l, 0, 1) for l in range(len(shapes))]
    bottom = [(l, n - 1, 1 if n > 1 else 0) for l, n in enumerate(n_ty)]
    rows, start = [v for hw in shapes for v in hw], 0
    for l, first_row, n_rows in inner + top + bottom:
        rows += [l, start, first_row * TILE, n_tx[l]]
        start += n_rows * n_tx[l]
    return start, tuple(rows)


@functools.lru_cache(maxsize=64)
def _launch_table(shapes: tuple):
    """tile_table as the kernel takes it (a ctypes array), made once per
    shape tuple so that a launch spends no host time on it."""
    n_blocks, rows = tile_table(shapes)
    return n_blocks, (ctypes.c_int * len(rows))(*rows)


def fast_score_nms(canvas: torch.Tensor, shapes, border: int = 16):
    """K1 on `canvas` ([L, H, W] float32, levels in the top-left corner with
    true sizes `shapes`). CUDA tensor: the kernel; CPU tensor: the plain
    version."""
    if not canvas.is_cuda:
        return fast_score_nms_plain(canvas, shapes, border)
    L, H, W = canvas.shape
    if canvas.dtype != torch.float32 or not canvas.is_contiguous():
        raise ValueError("fast_score_nms: canvas must be contiguous float32")
    if len(shapes) != L or L > MAX_LEVELS:
        raise ValueError(f"fast_score_nms: {len(shapes)} shapes for {L} "
                         f"levels (at most {MAX_LEVELS})")
    if any(h > H or w > W for h, w in shapes):
        raise ValueError("fast_score_nms: a level exceeds the canvas")
    n_blocks, table = _launch_table(tuple(map(tuple, shapes)))
    if not n_blocks:
        raise ValueError("fast_score_nms: every level is empty")
    out = torch.empty_like(canvas)
    with torch.cuda.device(canvas.device):
        KERNEL(canvas.data_ptr(), out.data_ptr(),
               ctypes.cast(table, ctypes.c_void_p), n_blocks, L, H, W, border,
               torch.cuda.current_stream().cuda_stream)
    return out
