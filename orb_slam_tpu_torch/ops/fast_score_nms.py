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
[border, h-border) x [border, w-border), else 0. Canvas outside every
level's [0, h) x [0, w) is left unwritten by the kernel (as by the Pallas
kernel) and zeroed by the plain version; callers mask it
(ops/fast_stack.py::KeypointSelector).

Every output value is a min or max of exactly rounded f32 differences, so
the kernel equals the plain version exactly, whatever order it reduces in.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from orb_slam_tpu_torch._build import CudaKernel
from orb_slam_tpu_torch.ops.fast import fast_score_stack, level_interior

MAX_LEVELS = 32  # LevelShapes in csrc/fast_score_nms.cu

KERNEL = CudaKernel(
    "fast_score_nms.cu", "fast_score_nms",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


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
    hw = (ctypes.c_int * (2 * L))(*[v for hw in shapes for v in hw])
    out = torch.empty_like(canvas)
    with torch.cuda.device(canvas.device):
        KERNEL(canvas.data_ptr(), out.data_ptr(),
               ctypes.cast(hw, ctypes.c_void_p), L, H, W, border,
               torch.cuda.current_stream().cuda_stream)
    return out
