"""Kernel K5: the keypoint selection of the stacked detectors on the card.

K5 (csrc/keypoint_select.cu) computes what `KeypointSelector.plain`
(ops/fast_stack.py, the port of `_select_from_masked`,
orb_slam_tpu/ops/fast_stack.py:295-408) computes from a masked score
canvas: the per-cell threshold fallback, the level's pool, the quota
redistribution and retainBest, bit for bit, in two launches. It replaces
no Pallas kernel: the JAX package runs this tail as XLA ops.

`keypoint_select` launches the kernel for a CUDA tensor and runs the plain
version only for a CPU tensor. The kernel reads each level only inside its
true size, so the canvas outside the levels (which K1 leaves unwritten)
is never read.
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam_tpu_torch._build import CudaKernel

MAX_LEVELS = 32  # kMaxLevels in csrc/keypoint_select.cu
# the shared memory a block may take on the H100 (227 KB), less the
# kernels' static arrays
MAX_DYNAMIC_SMEM = 232448 - 2048

KERNEL = CudaKernel(
    "keypoint_select.cu", "keypoint_select",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p])


class LaunchPlan:
    """What a K5 launch needs of a selector, made once: the level table as
    the kernel takes it (`table`, a ctypes array, so a launch copies
    nothing from the host: (h, w, rows, cols, cellH, cellW, k_tot, quota,
    first cell, first scratch slot) of each level), the
    cells (one block each in launch 1), the scratch slots (k_tot 64-bit
    keys per cell) and the dynamic shared memory of both launches (a
    cell's k_tot keys; a level's k_tot retained keys and flat indices and
    9 ints per cell). Raises ValueError if the table does not fit the
    kernel."""

    def __init__(self, selector):
        shapes, grids = selector.shapes, selector.grids
        k_tots, quotas = selector.k_tots, selector.quotas
        if len(shapes) > MAX_LEVELS:
            raise ValueError(f"keypoint_select: {len(shapes)} levels "
                             f"(at most {MAX_LEVELS})")
        if selector.th_ini < 0 or selector.th_min < 0:
            raise ValueError("keypoint_select: negative thresholds")
        self.Q = max(quotas)
        if not 1 <= self.Q <= max(k_tots):
            raise ValueError(f"keypoint_select: Qmax {self.Q} outside "
                             f"[1, {max(k_tots)}]")
        self.cell_smem = 8 * max(k_tots)
        self.level_smem = max(12 * k + 36 * r * c
                              for (r, c, _, _), k in zip(grids, k_tots))
        if max(self.cell_smem, self.level_smem) > MAX_DYNAMIC_SMEM:
            raise ValueError(
                f"keypoint_select: shared memory {self.cell_smem} / "
                f"{self.level_smem} bytes exceeds {MAX_DYNAMIC_SMEM}")
        rows, self.n_cells, self.n_slots = [], 0, 0
        for (h, w), (r, c, ch, cw), k, q in zip(shapes, grids, k_tots, quotas):
            rows += [h, w, r, c, ch, cw, k, q, self.n_cells, self.n_slots]
            self.n_cells += r * c
            self.n_slots += r * c * k
        self.table = (ctypes.c_int * len(rows))(*rows)


def keypoint_select(base: torch.Tensor, selector):
    """The selection of `selector` (a KeypointSelector) on the masked score
    canvas `base` ([L, H, W] float32). CUDA tensor: K5; CPU tensor: the
    plain version. Returns (xy [L, Qmax, 2] int32 level-local (x, y), score
    [L, Qmax] f32, valid [L, Qmax] bool)."""
    if not base.is_cuda:
        return selector.plain(base)
    plan = selector.launch_plan()
    L = len(selector.shapes)
    if base.dtype != torch.float32 or not base.is_contiguous():
        raise ValueError("keypoint_select: canvas must be contiguous float32")
    if base.dim() != 3 or base.shape[0] != L:
        raise ValueError(f"keypoint_select: canvas {tuple(base.shape)} for "
                         f"{L} levels")
    _, H, W = base.shape
    if any(h > H or w > W for h, w in selector.shapes):
        raise ValueError("keypoint_select: a level exceeds the canvas")
    dev, Q = base.device, plan.Q
    keys = torch.empty(max(plan.n_slots, 1), dtype=torch.int64, device=dev)
    info = torch.empty(3 * plan.n_cells, dtype=torch.int32, device=dev)
    xy = torch.empty((L, Q, 2), dtype=torch.int32, device=dev)
    score = torch.empty((L, Q), dtype=torch.float32, device=dev)
    valid = torch.empty((L, Q), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        KERNEL(base.data_ptr(), ctypes.cast(plan.table, ctypes.c_void_p), L,
               H, W, selector.border, selector.th_ini, selector.th_min,
               plan.n_cells, Q, plan.cell_smem, plan.level_smem,
               keys.data_ptr(), info.data_ptr(), xy.data_ptr(),
               score.data_ptr(), valid.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    return xy, score, valid
