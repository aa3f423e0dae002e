"""Kernel K3: FAST-9/16 score and 3x3 NMS over the whole level canvas.

Port of the Pallas kernel `fast_score_nms_pallas` / `_make_fast_kernel`
(orb_slam_tpu/ops/pallas_fast.py:32-85), which is the front of the XLA
stacked detector (orb_slam_tpu/ops/fast_stack.py:149-152): the Harris
(nScoreType=0) extraction runs it once per frame. The CUDA kernel is
csrc/fast_score_rect.cu; `fast_score_nms_rect_plain` is the same function
in plain PyTorch.

Both return (score [L, H, W] f32, keep [L, H, W] bool) for EVERY canvas
pixel: the score reads the canvas edge-padded by 3, and the NMS ignores
neighbours outside the canvas (the -inf init of reduce_window). That is
not K1's 1-pixel replicated score halo (ops/fast_score_nms.py), so the two
plain versions differ on the canvas edge. Every value is a min or max of
exactly rounded differences: the kernel is bit-equal to the plain version.

`fast_score_nms_rect` launches the kernel for a CUDA tensor and runs the
plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from orb_slam_tpu_torch._build import CudaKernel
from orb_slam_tpu_torch.ops.fast import fast_score_stack

MAX_LEVELS = 32  # kMaxLevels in csrc/fast_score_rect.cu

KERNEL = CudaKernel(
    "fast_score_rect.cu", "fast_score_rect",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def fast_score_nms_rect_plain(stack: torch.Tensor):
    """Plain PyTorch K3: [L, H, W] f32 -> (score f32, keep bool)."""
    score = fast_score_stack(stack)
    mx = F.max_pool2d(score[None], 3, stride=1, padding=1)[0]   # -inf pad
    return score, score >= mx


def fast_score_nms_rect(stack: torch.Tensor):
    """K3 on `stack` ([L, H, W] float32). CUDA tensor: the kernel; CPU
    tensor: the plain version."""
    if not stack.is_cuda:
        return fast_score_nms_rect_plain(stack)
    if stack.dtype != torch.float32 or not stack.is_contiguous():
        raise ValueError("fast_score_nms_rect: stack must be contiguous float32")
    if stack.ndim != 3 or not 1 <= stack.shape[0] <= MAX_LEVELS:
        raise ValueError(f"fast_score_nms_rect: stack {tuple(stack.shape)} is "
                         f"not [L, H, W] with 1 <= L <= {MAX_LEVELS}")
    L, H, W = stack.shape
    score = torch.empty_like(stack)
    keep = torch.empty(stack.shape, dtype=torch.bool, device=stack.device)
    with torch.cuda.device(stack.device):
        KERNEL(stack.data_ptr(), score.data_ptr(), keep.data_ptr(), L, H, W,
               torch.cuda.current_stream().cuda_stream)
    return score, keep
