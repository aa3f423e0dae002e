"""SE(3) as (..., 4, 4) homogeneous matrices.

Port of orb_slam_tpu/geometry/se3.py: `se3_identity` (:18-19),
`se3_from_rt` (:22-29), `se3_rotation` and `se3_translation` (:32-37),
`se3_compose` (:40-41), `se3_inverse` (:44-48), `se3_apply` (:51-53),
`_left_jacobian_factors` (:56-65), `se3_exp` (:68-80) and `se3_log`
(:83-98). The tangent is [rho(3), phi(3)], translation first. Every
function works over leading batch dimensions, on its input's device and
dtype.
"""

from __future__ import annotations

import torch

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.geometry.so3 import _hat, so3_exp, so3_log

_EPS = 1e-8


def se3_identity(dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The identity on `device` (the card unless the caller names
    another)."""
    return torch.eye(4, dtype=dtype, device=require_device(device))


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


def se3_rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def se3_translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def se3_compose(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    return T1 @ T2


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Points (..., 3) through T (..., 4, 4) -> (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


def _left_jacobian_factors(theta2: torch.Tensor):
    """A = sin(t) / t, B = (1 - cos t) / t^2, C = (1 - A) / t^2, with the
    Taylor series below theta^2 = 1e-8."""
    small = theta2 < _EPS
    safe_t2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe_t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / safe_t2)
    return A, B, C


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent (..., 6) -> (..., 4, 4); t = V rho, V = I + B W + C W^2."""
    rho, phi = xi[..., :3], xi[..., 3:]
    _, B, C = _left_jacobian_factors((phi * phi).sum(-1))
    W = _hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + B[..., None, None] * W + C[..., None, None] * (W @ W)
    return se3_from_rt(so3_exp(phi), (V @ rho[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> tangent (..., 6) [rho, phi]; rho = V^-1 t with
    V^-1 = I - W / 2 + (1 - A / (2 B)) / theta^2 W^2, whose factor is
    1/12 + theta^2/720 below theta^2 = 1e-8."""
    t = T[..., :3, 3]
    phi = so3_log(T[..., :3, :3])
    theta2 = (phi * phi).sum(-1)
    A, B, _ = _left_jacobian_factors(theta2)
    W = _hat(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    small = theta2 < _EPS
    safe_t2 = torch.where(small, 1.0, theta2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / safe_t2)
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([(Vinv @ t[..., None])[..., 0], phi], -1)
