"""SO(3): the hat operator and the exponential map.

Port of orb_slam_tpu/geometry/so3.py: `_hat` (:18-29) and `so3_exp`
(:32-48). Batched over leading dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of an axis vector: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3), with the JAX
    version's Taylor branch below theta^2 = 1e-8."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    W = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)
