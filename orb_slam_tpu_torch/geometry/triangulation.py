"""Linear (DLT) triangulation and two-view checks.

Port of orb_slam_tpu/geometry/triangulation.py:13-52: `triangulate_dlt`,
`depth_in_frame` and `parallax_cos` (Initializer::Triangulate,
src/Initializer.cc:732-745; the SVD triangulation of
LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:205-371), batched
over leading dimensions.
"""

from __future__ import annotations

import torch


def triangulate_dlt(xn1, xn2, P1, P2):
    """xn1, xn2 (..., 2) normalized coordinates; P1, P2 (..., 3, 4)
    projection matrices. Returns (..., 3) world points: the smallest
    eigenvector of the 4x4 Gram matrix A^T A (its sign cancels in the
    divide). Degenerate rows give garbage that the callers' gates
    reject."""
    rows = []
    for xn, P in ((xn1, P1), (xn2, P2)):
        x, y = xn[..., 0], xn[..., 1]
        rows.append(x[..., None] * P[..., 2, :] - P[..., 0, :])
        rows.append(y[..., None] * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(rows, dim=-2)                     # (..., 4, 4)
    G = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(G)                       # ascending eigenvalues
    X = V[..., :, 0]
    w = X[..., 3]
    safe = torch.where(w.abs() < 1e-12, 1e-12, w)
    return X[..., :3] / safe[..., None]


def depth_in_frame(T_cw, p_world):
    """z of world points in the camera frame; T_cw (..., 4, 4)."""
    return (T_cw[..., 2, :3] @ p_world[..., None])[..., 0] + T_cw[..., 2, 3]


def parallax_cos(C1, C2, p_world):
    """Cosine of the ray parallax at a point between camera centres C1, C2
    (..., 3); the reference gates cosParallax < 0.9998."""
    r1 = p_world - C1
    r2 = p_world - C2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return (r1 * r2).sum(-1) / (n1 * n2).clamp(min=1e-12)
