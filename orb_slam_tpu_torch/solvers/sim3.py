"""Sim3 RANSAC and Sim3 refinement, for loop closing.

Port of orb_slam_tpu/solvers/sim3.py: `_project` (:25-29), `sim3_ransac`
(:32-77; the reference's Sim3Solver, src/Sim3Solver.cc, Horn's closed form
on 3-point sets with mutual reprojection inlier checks) and
`optimize_sim3` (:80-146; Optimizer::OptimizeSim3, src/Optimizer.cc:
791-987, one Sim3 vertex with projection residuals both ways, Huber,
and the two-stage chi2-gated schedule).

The 300 minimal sets come from two_view.sample_minimal_sets (Gumbel
top-3 over the valid rows from a torch.Generator: `jax.random`'s draws
cannot be repeated, so the tests pass JAX's sets in as `idx`), and all 300
Horn fits are one batched `horn_sim3` call; the winner is refitted on its
inliers with Horn's weights and kept only if it keeps as many.
`optimize_sim3` takes its Jacobian by forward-mode AD through `sim3_exp`,
as JAX's `jax.jacfwd` (:125): `torch.func.jacfwd` of a tangent with a
leading batch dimension of one (on a 0-dim tensor, forward AD gives a
Python scalar operand a float64 tangent). The 7x7 step is `solve_ex` and
a non-finite step is zeroed (:131-132). Nothing reads the device on the
host. Matmuls need TF32 off, PyTorch's default, in place of `precise_jit`.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from orb_slam_tpu_torch.geometry.horn import horn_sim3
from orb_slam_tpu_torch.geometry.sim3 import sim3_exp
from orb_slam_tpu_torch.solvers.two_view import sample_minimal_sets


def _project(p_cam, K_mat):
    z = p_cam[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = K_mat[0, 0] * p_cam[..., 0] / z + K_mat[0, 2]
    v = K_mat[1, 1] * p_cam[..., 1] / z + K_mat[1, 2]
    return torch.stack([u, v], -1)


def _mutual_inliers(s, R, t, p1, p2, uv1, uv2, valid, sigma2_1, sigma2_2, K_mat):
    """[..., N] rows whose p2 projects into image 1 through (s, R, t) and
    p1 into image 2 through its inverse within 9.21 sigma^2
    (Sim3Solver.cc:335-359); s (...,), R (..., 3, 3), t (..., 3)."""
    Rt = R.transpose(-1, -2)
    p2_in1 = s[..., None, None] * p2 @ Rt + t[..., None, :]
    e1 = ((_project(p2_in1, K_mat) - uv1) ** 2).sum(-1)
    sinv = 1.0 / s
    p1_in2 = (sinv[..., None, None] * p1 @ R
              - (sinv[..., None] * (Rt @ t[..., None])[..., 0])[..., None, :])
    e2 = ((_project(p1_in2, K_mat) - uv2) ** 2).sum(-1)
    return valid & (e1 < 9.21 * sigma2_1) & (e2 < 9.21 * sigma2_2)


def sim3_ransac(p1, p2, uv1, uv2, valid, sigma2_1, sigma2_2, K_mat, *,
                generator=None, idx=None, n_hypotheses: int = 300,
                fix_scale: bool = False):
    """S12 (p1 ~ s R p2 + t) from matched camera-frame points p1, p2
    [N, 3] with their pixels uv1, uv2 [N, 2] and level variances
    sigma2_1, sigma2_2 [N]; the minimal sets are
    `sample_minimal_sets(valid, n_hypotheses, 3, generator=, idx=)`.
    Returns (s, R, t, inliers [N], n_inliers) as device tensors."""
    sets = sample_minimal_sets(valid, n_hypotheses, 3, generator=generator,
                               idx=idx)
    args = (p1, p2, uv1, uv2, valid, sigma2_1, sigma2_2, K_mat)
    ss, Rs, ts = horn_sim3(p1[sets], p2[sets], fix_scale=fix_scale)
    inls = _mutual_inliers(ss, Rs, ts, *args)                  # [H, N]
    counts = inls.sum(-1)
    b = torch.argmax(counts)                                   # the first maximum
    # the refit on the winning inlier set (JAX's improvement on the
    # reference, which keeps the minimal-set estimate)
    s_f, R_f, t_f = horn_sim3(p1, p2, weights=inls[b].to(p1.dtype),
                              fix_scale=fix_scale)
    inl_f = _mutual_inliers(s_f, R_f, t_f, *args)
    better = inl_f.sum() >= counts[b]
    s_o = torch.where(better, s_f, ss[b])
    R_o = torch.where(better, R_f, Rs[b])
    t_o = torch.where(better, t_f, ts[b])
    inl_o = torch.where(better, inl_f, inls[b])
    return s_o, R_o, t_o, inl_o, inl_o.sum()


def optimize_sim3(s0, R0, t0, p1, p2, uv1, uv2, valid, inv_sigma2_1,
                  inv_sigma2_2, K_mat, iters: int = 10, fix_scale: bool = False,
                  chi2_th: float = 10.0):
    """Refine S12 = (s0, R0, t0): iters // 2 Gauss-Newton steps on every
    valid row with Huber weights, the chi2 gate at `chi2_th` both ways,
    then `iters` steps on the inliers. Returns (s, R, t, inliers [N],
    n_inliers)."""
    dev = p1.device
    delta = float(torch.sqrt(torch.tensor(chi2_th, dtype=torch.float32)))

    def residuals(x):
        """x [1, 7] -> (r1 [N, 2], r2 [N, 2], (s [1], R, t))."""
        ds, dR, dt = sim3_exp(x)
        s = s0 * ds
        R = dR[0] @ R0
        t = (ds[:, None] * (dR @ t0[:, None])[..., 0] + dt)[0]
        r1 = _project(s[:, None] * p2 @ R.T + t, K_mat) - uv1
        sinv = 1.0 / s
        r2 = _project(sinv[:, None] * p1 @ R - sinv[:, None] * (R.T @ t), K_mat) - uv2
        return r1, r2, (s, R, t)

    def chi2_of(x):
        r1, r2, _ = residuals(x)
        return (r1 * r1).sum(-1) * inv_sigma2_1, (r2 * r2).sum(-1) * inv_sigma2_2

    def gn(x, active, n_iters):
        def flat_res(x):
            r1, r2, _ = residuals(x)
            c1, c2 = chi2_of(x)
            e1 = torch.sqrt(c1.clamp(min=1e-12))
            e2 = torch.sqrt(c2.clamp(min=1e-12))
            h1 = torch.sqrt(torch.where(e1 <= delta, torch.ones_like(e1), delta / e1)
                            * inv_sigma2_1 * active)
            h2 = torch.sqrt(torch.where(e2 <= delta, torch.ones_like(e2), delta / e2)
                            * inv_sigma2_2 * active)
            return torch.cat([(r1 * h1[:, None]).reshape(-1),
                              (r2 * h2[:, None]).reshape(-1)])

        eye = torch.eye(7, device=dev)
        for _ in range(n_iters):
            r = flat_res(x)
            J = jacfwd(flat_res)(x).reshape(r.shape[0], 7)        # [4N, 7]
            H = J.T @ J + 1e-6 * eye
            b = J.T @ r
            if fix_scale:
                keep = (torch.arange(7, device=dev) < 6).to(H.dtype)
                H = H * keep[:, None] * keep[None, :] + eye * (1.0 - keep)[:, None]
                b = b * keep
            dx, info = torch.linalg.solve_ex(H, -b)
            ok = (info == 0) & torch.isfinite(dx).all()
            x = x + torch.where(ok, dx, torch.zeros_like(dx))[None]
        return x

    x = torch.zeros((1, 7), device=dev)
    active = valid.to(torch.float32)
    x = gn(x, active, iters // 2)
    c1, c2 = chi2_of(x)
    inlier = valid & (c1 < chi2_th) & (c2 < chi2_th)
    x = gn(x, inlier.to(torch.float32), iters)
    c1, c2 = chi2_of(x)
    inlier = valid & (c1 < chi2_th) & (c2 < chi2_th)
    _, _, (s, R, t) = residuals(x)
    return s[0], R, t, inlier, inlier.sum()
