"""Pyramid level sizes, the per-level pyramid, the Gaussian blur and
grayscale conversion.

Port of orb_slam_tpu/ops/image.py: `pyramid_shapes` (:16-22),
`build_pyramid` (:25-37), `gaussian_kernel1d` (:40-46), `gaussian_blur`
(:48-64) and `to_grayscale` (:66-76). Images are float32 [H, W] in
[0, 255].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(height: int, width: int, n_levels: int,
                   scale_factor: float):
    """Static per-level (H, W) sizes, rounding like the reference."""
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        shapes.append((max(8, int(round(height * s))),
                       max(8, int(round(width * s)))))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float):
    """Successive bilinear downscale, each level from the previous one like
    the reference, as a list of [H_l, W_l] f32 tensors.

    JAX resizes with jax.image.resize(bilinear, antialias=False): half-pixel
    centres, weights renormalised where a sample leaves the image. Here it
    is F.interpolate(bilinear, align_corners=False, antialias=False):
    half-pixel centres, indices clamped at the edge, which gives the same
    value (the two input pixels are one). The two round the weighted sum
    differently, so values differ in the last bits (measured on the CPU:
    at most a few 1e-4 at 640x480, tests/test_torch_extract_exact.py)."""
    H, W = img.shape
    shapes = pyramid_shapes(H, W, n_levels, scale_factor)
    levels = [img]
    for h, w in shapes[1:]:
        levels.append(F.interpolate(levels[-1][None, None], size=(h, w),
                                    mode="bilinear", align_corners=False,
                                    antialias=False)[0, 0])
    return levels


def gaussian_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Matches cv::getGaussianKernel (normalized sampled Gaussian)."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of [H, W] with BORDER_REFLECT_101, as
    cv::GaussianBlur(7, 7, 2, 2) before rBRIEF sampling
    (src/ORBextractor.cc:743). The sums run in the JAX order (rows, then
    columns, each ((0 + k0 p0) + k1 p1) + ...) with f32 weights."""
    k = [float(v) for v in gaussian_kernel1d(ksize, sigma)]
    r = ksize // 2
    H, W = img.shape
    padded = F.pad(img[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + k[i] * padded[i:i + H]
    padded = F.pad(out[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    out2 = torch.zeros_like(img)
    for i in range(ksize):
        out2 = out2 + k[i] * padded[:, i:i + W]
    return out2


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [..., H, W, 3] or gray [..., H, W] -> float32 [..., H, W],
    with OpenCV's RGB2GRAY weights (the reference uses cvtColor,
    src/Tracking.cc:189-197)."""
    if img.ndim >= 3 and img.shape[-1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                         device=img.device)
        return torch.round(img.to(torch.float32) @ w)
    return img.to(torch.float32)
