"""Horn's closed-form absolute orientation: the Sim3 between matched 3D
point sets.

Port of orb_slam_tpu/geometry/horn.py:16-65 (`horn_sim3`; the reference's
Sim3Solver::computeT, src/Sim3Solver.cc:226-332, after Horn 1987), batched
over leading dimensions. The rotation is the largest eigenvector of
Horn's 4x4 N matrix, from `torch.linalg.eigh` (ascending eigenvalues);
its sign cancels in `quat_to_rot`.
"""

from __future__ import annotations

import torch

from orb_slam_tpu_torch.geometry.so3 import quat_to_rot


def horn_sim3(P1, P2, weights=None, fix_scale: bool = False):
    """(s, R, t) with P1 ~ s R P2 + t. P1, P2 (..., N, 3); weights
    (..., N) non-negative, None = all ones. Returns s (...,), R (..., 3, 3),
    t (..., 3); s = 1 with fix_scale."""
    if weights is None:
        weights = torch.ones(P1.shape[:-1], dtype=P1.dtype, device=P1.device)
    wn = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-12)
    O1 = (wn[..., None] * P1).sum(-2)
    O2 = (wn[..., None] * P2).sum(-2)
    Pr1 = P1 - O1[..., None, :]
    Pr2 = P2 - O2[..., None, :]
    # M = sum w pr2 pr1^T: the largest eigenvector of N is then the
    # quaternion of the rotation taking frame-2 vectors onto frame 1
    M = torch.einsum("...n,...ni,...nj->...ij", wn, Pr2, Pr1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    _, evecs = torch.linalg.eigh(N)
    q_wxyz = evecs[..., :, -1]
    R = quat_to_rot(torch.cat([q_wxyz[..., 1:4], q_wxyz[..., 0:1]], -1))
    RPr2 = (R[..., None, :, :] @ Pr2[..., None])[..., 0]
    if fix_scale:
        s = torch.ones(P1.shape[:-2], dtype=P1.dtype, device=P1.device)
    else:
        # the reference's asymmetric form (src/Sim3Solver.cc:305-315)
        num = (wn * (Pr1 * RPr2).sum(-1)).sum(-1)
        den = torch.clamp((wn * (Pr2 * Pr2).sum(-1)).sum(-1), min=1e-12)
        s = num / den
    t = O1 - s[..., None] * (R @ O2[..., None])[..., 0]
    return s, R, t
