"""SO(3): the hat operator, the exponential map and unit quaternions.

Port of orb_slam_tpu/geometry/so3.py: `_hat` (:18-29), `so3_exp`
(:32-48), `so3_log` (:49-89), `quat_to_rot`, `rot_to_quat`, `quat_mul` and
`quat_normalize` (:92-159). Batched over leading dimensions. Quaternions
are [x, y, z, w].
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
    # ones_like, not the Python scalar: under torch.func.jacfwd a scalar
    # branch of torch.where gets a float64 tangent
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    W = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3). theta is
    atan2(|vee| / 2, (tr - 1) / 2); below theta = 1e-5 the factor is the
    Taylor series of theta / (2 sin theta); within 1e-3 of pi the axis
    comes from the largest diagonal entry of (R + I) / 2 (the first on
    ties, as jnp.argmax), its sign from vee."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    vee_norm = torch.sqrt((vee * vee).sum(-1) + 1e-24)   # 2 sin(theta)
    theta = torch.atan2(vee_norm * 0.5, cos_t)
    small = theta < 1e-5
    near_pi = theta > (torch.pi - 1e-3)
    safe_norm = torch.where(small | near_pi, torch.ones_like(vee_norm), vee_norm)
    k_generic = theta / safe_norm
    k_small = 0.5 + theta * theta / 12.0
    w_generic = torch.where(small[..., None], k_small[..., None],
                            k_generic[..., None]) * vee
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    S = (R + eye) * 0.5
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], -1)
    k = torch.argmax(diag, -1, keepdim=True)
    d = torch.gather(diag, -1, k)[..., 0]
    axis_unnorm = torch.gather(S, -1, k[..., None].expand(S.shape[:-1] + (1,)))[..., 0]
    axis = axis_unnorm / torch.sqrt(torch.clamp(d, min=_EPS))[..., None]
    axis = axis / torch.sqrt((axis * axis).sum(-1, keepdim=True) + _EPS)
    sign = 1.0 - 2.0 * ((axis * vee).sum(-1) < 0.0).to(R.dtype)
    w_pi = axis * (sign * theta)[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [x, y, z, w] -> rotation (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> unit quaternion (..., 4) [x, y, z, w] with
    w >= 0: all four Shepperd candidates, the one with the largest
    squared magnitude selected (the first on ties, as jnp.argmax)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    safe = lambda v: torch.where(v < _EPS, 1.0, v)
    sw = 2.0 * torch.sqrt(safe(qw2))
    sx = 2.0 * torch.sqrt(safe(qx2))
    sy = 2.0 * torch.sqrt(safe(qy2))
    sz = 2.0 * torch.sqrt(safe(qz2))
    cand_w = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw,
                          (m10 - m01) / sw, sw / 4.0], -1)
    cand_x = torch.stack([sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx,
                          (m21 - m12) / sx], -1)
    cand_y = torch.stack([(m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy,
                          (m02 - m20) / sy], -1)
    cand_z = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0,
                          (m10 - m01) / sz], -1)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), -1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], -2)   # (..., 4, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, [x, y, z, w]."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=_EPS)
