"""SE(3) as (..., 4, 4) homogeneous matrices.

Port of orb_slam_tpu/geometry/se3.py: `se3_from_rt` (:22-29),
`se3_inverse` (:44-48) and `se3_exp` (:65-80, with its left-Jacobian
factors :56-62). The tangent is [rho(3), phi(3)], translation first.
"""

from __future__ import annotations

import torch

from orb_slam_tpu_torch.geometry.so3 import _hat, so3_exp

_EPS = 1e-8


def se3_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], -1)
    # the row (0, 0, 0, 1) built on the device: assigning a Python scalar
    # into a 0-dim CUDA view would copy it from the host and sync
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        batch + (1, 4))
    return torch.cat([top, bottom], -2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent (..., 6) -> (..., 4, 4); t = V rho, V = I + B W + C W^2."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = (phi * phi).sum(-1)
    small = theta2 < _EPS
    safe_t2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe_t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / safe_t2)
    W = _hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + B[..., None, None] * W + C[..., None, None] * (W @ W)
    return se3_from_rt(so3_exp(phi), (V @ rho[..., None])[..., 0])
