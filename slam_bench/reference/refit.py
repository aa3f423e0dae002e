"""Plain refits of poses and points from the program's own matches: the
benchmark's reference for tracking and for local mapping's bundle
adjustment.

A tracked frame's pose is, by ORB-SLAM's definition, the minimum of the
Huber-weighted reprojection error of its inlier matches against the map
points it tracked (Optimizer::PoseOptimization); a keyframe's pose and a
point's position after local bundle adjustment are a stationary point of
the same cost over the keyframes and points (Optimizer::
LocalBundleAdjustment), so holding the points fixed and refitting the
pose, or holding the poses fixed and refitting a point, lands where the
program already is. These refits run Gauss-Newton in float64 to
convergence from the program's answer, with the information 1/sigma^2 of
each observation's pyramid level and the Huber threshold sqrt(5.991) of
the reference, and are written here from those equations alone.

`rnd` is the control's hook: `bf16` rounds every intermediate result to
bfloat16, as a change that solved in bf16 would.
"""

from __future__ import annotations

import math

import torch

CHI2_MONO = 5.991
HUBER_DELTA = math.sqrt(CHI2_MONO)
ITERATIONS = 25


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _same(x):
    return x


def rodrigues(phi: torch.Tensor) -> torch.Tensor:
    """[..., 3] rotation vectors -> [..., 3, 3] rotations."""
    th = torch.linalg.norm(phi, dim=-1, keepdim=True)[..., None]
    k = phi / torch.clamp(th[..., 0], min=1e-300)
    z = torch.zeros_like(k[..., 0])
    Kx = torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                      torch.stack([k[..., 2], z, -k[..., 0]], -1),
                      torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=phi.dtype).expand(Kx.shape)
    return eye + torch.sin(th) * Kx + (1.0 - torch.cos(th)) * (Kx @ Kx)


def _huber_weights(r, inv_s2):
    chi2 = (r * r).sum(-1) * inv_s2
    e = torch.sqrt(torch.clamp(chi2, min=1e-24))
    return inv_s2 * torch.where(e <= HUBER_DELTA, 1.0, HUBER_DELTA / e)


def _projection(pc, K):
    """(pixels [..., 2], d pixel / d camera point [..., 2, 3])."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    iz = 1.0 / z
    uv = torch.stack([fx * x * iz + cx, fy * y * iz + cy], -1)
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx * iz, zero, -fx * x * iz * iz], -1),
                     torch.stack([zero, fy * iz, -fy * y * iz * iz], -1)], -2)
    return uv, J


def pose_refit(T, points, uv, inv_s2, K, rnd=_same, iters=ITERATIONS):
    """The pose [4, 4] (world to camera) that minimises the Huber cost of
    observations uv [n, 2] of fixed world points [n, 3], from T."""
    T = rnd(torch.as_tensor(T, dtype=torch.float64).clone())
    X = rnd(torch.as_tensor(points, dtype=torch.float64))
    uv = torch.as_tensor(uv, dtype=torch.float64)
    w0 = torch.as_tensor(inv_s2, dtype=torch.float64)
    K = torch.as_tensor(K, dtype=torch.float64)
    for _ in range(iters):
        pc = rnd(X @ T[:3, :3].T + T[:3, 3])
        ok = pc[:, 2] > 0
        px, Jp = _projection(pc, K)
        r = rnd(px - uv)
        hat = torch.zeros(len(pc), 3, 3, dtype=pc.dtype)
        hat[:, 0, 1], hat[:, 0, 2] = -pc[:, 2], pc[:, 1]
        hat[:, 1, 0], hat[:, 1, 2] = pc[:, 2], -pc[:, 0]
        hat[:, 2, 0], hat[:, 2, 1] = -pc[:, 1], pc[:, 0]
        # d camera point / (translation, rotation) of a left update
        J = rnd(Jp @ torch.cat([torch.eye(3, dtype=pc.dtype).expand_as(hat),
                                -hat], -1))
        w = _huber_weights(r, w0) * ok
        H = rnd(torch.einsum("n,nki,nkj->ij", w, J, J))
        b = rnd(torch.einsum("n,nki,nk->i", w, J, r))
        dx = rnd(-torch.linalg.solve(H, b))
        R = rodrigues(dx[3:])
        T_new = T.clone()
        T_new[:3, :3] = R @ T[:3, :3]
        T_new[:3, 3] = R @ T[:3, 3] + dx[:3]
        T = rnd(T_new)
    return T


def points_refit(X, poses, uv, inv_s2, mask, K, rnd=_same, iters=ITERATIONS):
    """(positions [m, 3] that minimise each point's Huber cost over its
    observations (poses [m, O, 4, 4], uv [m, O, 2], inv_s2 [m, O], mask
    [m, O] bool) with the poses fixed, from X [m, 3]; [m] bool, False
    where the observations leave the point undetermined)."""
    X = rnd(torch.as_tensor(X, dtype=torch.float64).clone())
    poses = rnd(torch.as_tensor(poses, dtype=torch.float64))
    uv = torch.as_tensor(uv, dtype=torch.float64)
    w0 = torch.as_tensor(inv_s2, dtype=torch.float64)
    K = torch.as_tensor(K, dtype=torch.float64)
    R, t = poses[..., :3, :3], poses[..., :3, 3]
    solved = torch.ones(len(X), dtype=torch.bool)
    for _ in range(iters):
        pc = rnd(torch.einsum("moij,mj->moi", R, X) + t)
        ok = mask & (pc[..., 2] > 0)
        px, Jp = _projection(pc, K)
        r = rnd(px - uv)
        J = rnd(Jp @ R)                                  # [m, O, 2, 3]
        w = _huber_weights(r, w0) * ok
        H = rnd(torch.einsum("mo,moki,mokj->mij", w, J, J))
        b = rnd(torch.einsum("mo,moki,mok->mi", w, J, r))
        step, info = torch.linalg.solve_ex(H, b[..., None])
        good = (info == 0) & torch.isfinite(step[..., 0]).all(-1)
        solved &= good
        X = rnd(X - torch.where(good[:, None], step[..., 0], 0.0))
    return X, solved


def project(T, X, K):
    """Pixels [..., 2] of world points X [..., 3] seen from poses T
    [..., 4, 4]."""
    pc = torch.einsum("...ij,...j->...i", T[..., :3, :3], X) + T[..., :3, 3]
    return _projection(pc, K)[0]


def center(T: torch.Tensor) -> torch.Tensor:
    """Camera centre of world-to-camera poses [..., 4, 4]."""
    T = torch.as_tensor(T, dtype=torch.float64)
    return -torch.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])
