"""Pyramid level sizes, the Gaussian kernel and grayscale conversion.

Port of orb_slam_tpu/ops/image.py: `pyramid_shapes` (:16-22),
`gaussian_kernel1d` (:40-46) and `to_grayscale` (:66-76). Images are
float32 [H, W] in [0, 255].
"""

from __future__ import annotations

import numpy as np
import torch


def pyramid_shapes(height: int, width: int, n_levels: int,
                   scale_factor: float):
    """Static per-level (H, W) sizes, rounding like the reference."""
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        shapes.append((max(8, int(round(height * s))),
                       max(8, int(round(width * s)))))
    return shapes


def gaussian_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Matches cv::getGaussianKernel (normalized sampled Gaussian)."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [..., H, W, 3] or gray [..., H, W] -> float32 [..., H, W],
    with OpenCV's RGB2GRAY weights (the reference uses cvtColor,
    src/Tracking.cc:189-197)."""
    if img.ndim >= 3 and img.shape[-1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                         device=img.device)
        return torch.round(img.to(torch.float32) @ w)
    return img.to(torch.float32)
