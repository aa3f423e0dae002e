"""Pose-only optimization: Gauss-Newton on one SE3 with Huber + chi2 gating,
and kernel K2, which runs the whole chain in one CUDA launch.

Port of orb_slam_tpu/solvers/pose_opt.py (`_residuals_jac` :26-60,
`solve6_cholesky` :63-96, `_gn_rounds` :99-139 as `pose_gn_plain`,
`orthonormalize_pose` :142-157, `pose_optimize` :160-183) and of the
Pallas kernel `pose_optimize_pallas` / `_make_pose_gn_kernel`
(orb_slam_tpu/solvers/pose_opt_pallas.py:113-252), whose CUDA source is
csrc/pose_gn.cu.

The chain (Optimizer::PoseOptimization, src/Optimizer.cc:154-285): 4
rounds of damped GN with per-round chi2 gates (9.21, 7.378, 5.991, 5.991)
re-evaluated between rounds, Huber IRLS weights, a damped 6x6 Cholesky
solve with a non-finite-step guard, left-multiplied se3 updates, and a
final Gram-Schmidt projection of the rotation. `pose_optimize` launches
K2 for CUDA tensors and runs `pose_gn_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam_tpu_torch._build import CudaKernel
from orb_slam_tpu_torch.geometry.se3 import se3_exp

HUBER_DELTA2 = 5.991
ROUND_CHI2 = (9.21, 7.378, 5.991, 5.991)
ROUND_ITERS = (10, 10, 7, 5)

KERNEL = CudaKernel(
    "pose_gn.cu", "pose_gn",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                  ctypes.c_void_p])


def _residuals_jac(T, points, uv, K):
    """Residuals r [N, 2], Jacobians J [N, 2, 6] w.r.t. a left se3 update
    T <- exp(xi) T, and camera depth z [N]."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pc = points @ T[:3, :3].T + T[:3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    r = torch.stack([fx * x / zs + cx - uv[:, 0],
                     fy * y / zs + cy - uv[:, 1]], -1)
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], -1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], -1)
    duv_dpc = torch.stack([du, dv], -2)                       # [N, 2, 3]
    hat = torch.stack([
        torch.stack([zero, -pc[:, 2], pc[:, 1]], -1),
        torch.stack([pc[:, 2], zero, -pc[:, 0]], -1),
        torch.stack([-pc[:, 1], pc[:, 0], zero], -1),
    ], -2)                                                    # [N, 3, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(hat.shape)
    J = duv_dpc @ torch.cat([eye, -hat], -1)                  # [N, 2, 6]
    return r, J, z


def solve6_cholesky(H, b):
    """x = H^-1 b for a 6x6 SPD H, unrolled Cholesky with the 1e-12 floor."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = (torch.sqrt(torch.clamp(s, min=1e-12)) if i == j
                       else s / L[j][j])
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def orthonormalize_pose(T):
    """Gram-Schmidt on the columns of T's rotation block."""
    R = T[:3, :3]
    c0 = R[:, 0] / torch.linalg.norm(R[:, 0])
    c1 = R[:, 1] - torch.dot(c0, R[:, 1]) * c0
    c1 = c1 / torch.linalg.norm(c1)
    c2 = torch.linalg.cross(c0, c1)
    out = T.clone()
    out[:3, :3] = torch.stack([c0, c1, c2], 1)
    return out


def pose_gn_plain(T0, points, uv, inv_sigma2, valid, K, damping=1e-3,
                  iters=ROUND_ITERS):
    """Plain PyTorch K2 (the JAX `_gn_rounds`). Returns (T [4, 4],
    inlier [N] bool)."""
    T = T0
    inlier = valid
    delta = float(torch.sqrt(torch.tensor(HUBER_DELTA2, dtype=torch.float32)))
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    for rnd in range(4):
        for _ in range(iters[rnd]):
            r, J, z = _residuals_jac(T, points, uv, K)
            chi2 = (r * r).sum(-1) * inv_sigma2
            e = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w_huber = torch.where(e <= delta, 1.0, delta / e)
            w = inv_sigma2 * w_huber * inlier.to(r.dtype) * (z > 0)
            A = torch.cat([J, r[:, :, None]], -1)             # [N, 2, 7]
            S = torch.einsum("nki,nkj->ij", A * w[:, None, None], A)
            dx = solve6_cholesky(S[:6, :6] + damping * eye6, -S[:6, 6])
            dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
            T = se3_exp(dx) @ T
        # re-gate on the updated pose; edges may re-enter
        # (src/Optimizer.cc:244-270)
        r, _, z = _residuals_jac(T, points, uv, K)
        chi2 = (r * r).sum(-1) * inv_sigma2
        inlier = valid & (chi2 <= ROUND_CHI2[rnd]) & (z > 0)
    return orthonormalize_pose(T), inlier


def pose_optimize(T_cw0, points, uv, inv_sigma2, valid, K, iters=ROUND_ITERS,
                  damping=1e-3):
    """Optimize one camera pose against fixed 3D points: K2 on the CUDA
    device of its inputs, the plain version for CPU ones. T_cw0 [4, 4],
    points [N, 3], uv [N, 2], inv_sigma2 [N] f32, valid [N] bool, K [3, 3].
    Returns (T_cw [4, 4], inlier [N] bool, n_inliers int32)."""
    if not points.is_cuda:
        T, inlier = pose_gn_plain(T_cw0, points, uv, inv_sigma2, valid, K,
                                  damping=damping, iters=iters)
        return T, inlier, inlier.sum(dtype=torch.int32)
    N = points.shape[0]
    expect = {"T_cw0": (T_cw0, (4, 4), torch.float32),
              "points": (points, (N, 3), torch.float32),
              "uv": (uv, (N, 2), torch.float32),
              "inv_sigma2": (inv_sigma2, (N,), torch.float32),
              "valid": (valid, (N,), torch.bool),
              "K": (K, (3, 3), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if (t.device != points.device or tuple(t.shape) != shape
                or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(f"pose_optimize: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {points.device}")
    if N < 1 or len(iters) != 4:
        raise ValueError("pose_optimize: needs rows and 4 round lengths")
    T = torch.empty((4, 4), dtype=torch.float32, device=points.device)
    inlier = torch.empty((N,), dtype=torch.bool, device=points.device)
    n_in = torch.empty((), dtype=torch.int32, device=points.device)
    with torch.cuda.device(points.device):
        KERNEL(T_cw0.data_ptr(), K.data_ptr(), points.data_ptr(),
               uv.data_ptr(), inv_sigma2.data_ptr(), valid.data_ptr(),
               T.data_ptr(), inlier.data_ptr(), n_in.data_ptr(), N, *iters,
               float(damping), torch.cuda.current_stream().cuda_stream)
    return T, inlier, n_in
