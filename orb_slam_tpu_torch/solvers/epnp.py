"""EPnP and its batched RANSAC, for relocalisation.

Port of orb_slam_tpu/solvers/epnp.py: `_control_points` (:29-38),
`_barycentric` (:41-50), `_build_M` (:53-68), `_rho` (:74-77), `_L6x10`
(:80-95), `_betas_case1/2/3` (:98-127), `_gauss_newton_betas`
(:130-148), `_pose_from_betas` (:151-160), `_reproj_err` (:163-168),
`epnp_solve` (:171-197) and `epnp_ransac` (:200-230); the reference's
PnPsolver (src/PnPsolver.cc, Lepetit et al.'s EPnP), with every
hypothesis solved at once instead of one minimal set at a time.

Every function takes leading batch dimensions: the 128 hypotheses of
`epnp_ransac` are one batch, where JAX vmaps. The JAX linear algebra
becomes `torch.linalg` (no Pallas kernel, so no kernel of ours), written
so that nothing raises where JAX returns NaN and nothing reads an info
flag on the host:
  * `jnp.linalg.lstsq` is the SVD least squares of JAX, with its cut-off
    rcond = eps * max(m, n) relative to the largest singular value (not
    `torch.linalg.lstsq`, whose CUDA driver assumes full rank and whose
    CPU default is another algorithm);
  * `jnp.linalg.solve` is `solve_ex`, NaN where it failed or its input
    was not finite;
  * every `eigh` and SVD goes through two_view's `_eigh` and `_svd`
    (non-finite inputs zeroed, NaN out), and Horn's alignment gets the
    same guard;
  * `jax.jacfwd` of the beta products is their closed-form Jacobian.
Eigenvectors are defined up to sign, and up to a basis within a repeated
eigenvalue. The control points' PCA directions take the sign the
eigensolver gives (LAPACK's ssyevd in JAX, MKL or cuSOLVER here), and
under noise another sign is another, equally valid estimate. A four-point
set makes M 8 x 12, so the four smallest eigenvalues of M'M are all
rounding noise and each hypothesis's betas follow the eigensolver's basis
of that null space. So the winning hypothesis can differ from JAX's, and
between the CPU and the card; what relocalisation uses, the inliers and
the pose refined on them, agrees (tests/test_torch_epnp.py). The minimal
sets come from
two_view.sample_minimal_sets (a torch.Generator: JAX's draws cannot be
repeated, so the tests pass JAX's sets in as `idx`). Matmuls need TF32
off, PyTorch's default, in place of JAX's `precise_jit`.
"""

from __future__ import annotations

import torch

from orb_slam_tpu_torch.geometry.horn import horn_sim3
from orb_slam_tpu_torch.solvers.two_view import (
    _eigh, _finite_in, _nan_where_not, _svd, sample_minimal_sets,
)

_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_ORDER = [(0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2),
          (0, 3), (1, 3), (2, 3), (3, 3)]


def _solve(A, b):
    """jnp.linalg.solve(A, b) for (..., n, n) and (..., n, m): solve_ex,
    NaN where the factorization failed or the input was not finite."""
    A0, ok = _finite_in(A)
    x, info = torch.linalg.solve_ex(A0, b)
    return _nan_where_not(ok & (info == 0), x)[0]


def _lstsq(A, b):
    """jnp.linalg.lstsq(A, b)[0] for A (..., m, n), b (..., m): the SVD
    solve with JAX's cut-off (singular values under eps * max(m, n) times
    the largest count as zero)."""
    m, n = A.shape[-2:]
    u, s, vh = _svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(m, n)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    uTb = (u.transpose(-1, -2) @ b[..., None])[..., 0]
    return (vh.transpose(-1, -2) @ (s_inv * uTb)[..., None])[..., 0]


def _control_points(pw):
    """World control points from centroid + PCA. pw (..., n, 3) -> cw
    (..., 4, 3), the largest direction first as in the reference."""
    c0 = pw.mean(-2)
    A = pw - c0[..., None, :]
    cov = A.transpose(-1, -2) @ A / pw.shape[-2]
    evals, evecs = _eigh(cov)  # ascending
    evals = torch.clamp(evals, min=1e-12)
    dirs = evecs.flip(-1) * torch.sqrt(evals.flip(-1))[..., None, :]
    return torch.stack([c0, c0 + dirs[..., :, 0], c0 + dirs[..., :, 1],
                        c0 + dirs[..., :, 2]], -2)


def _barycentric(pw, cw):
    """alphas (..., n, 4) with p = sum alpha_j c_j, sum alpha = 1."""
    B = (cw[..., 1:, :] - cw[..., :1, :]).transpose(-1, -2)     # (..., 3, 3)
    rhs = (pw - cw[..., :1, :]).transpose(-1, -2)               # (..., 3, n)
    eye = torch.eye(3, dtype=pw.dtype, device=pw.device)
    a123 = _solve(B + 1e-9 * eye, rhs).transpose(-1, -2)       # (..., n, 3)
    a0 = 1.0 - a123.sum(-1, keepdim=True)
    return torch.cat([a0, a123], -1)


def _build_M(alphas, uv, fx, fy, cx, cy):
    """(..., 2n, 12) EPnP system."""
    u, v = uv[..., 0], uv[..., 1]
    z = torch.zeros_like(u)
    Mu = torch.cat([torch.stack([a * fx, z, a * (cx - u)], -1)
                    for a in alphas.unbind(-1)], -1)           # (..., n, 12)
    Mv = torch.cat([torch.stack([z, a * fy, a * (cy - v)], -1)
                    for a in alphas.unbind(-1)], -1)
    return torch.cat([Mu, Mv], -2)


def _rho(cw):
    return torch.stack([((cw[..., a, :] - cw[..., b, :]) ** 2).sum(-1)
                        for a, b in _PAIRS], -1)               # (..., 6)


def _L6x10(V):
    """V (..., 12, 4) null-space basis (smallest eigenvalue first). Returns
    L (..., 6, 10) for the beta products ordered
    [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44]."""
    vs = [V[..., :, i].reshape(V.shape[:-2] + (4, 3)) for i in range(4)]
    dv = [torch.stack([v[..., a, :] - v[..., b, :] for a, b in _PAIRS], -2)
          for v in vs]                                         # (..., 6, 3)
    cols = []
    for i, j in _ORDER:
        dot = (dv[i] * dv[j]).sum(-1)
        cols.append(dot if i == j else 2.0 * dot)
    return torch.stack(cols, -1)


def _sqrt_abs(x):
    return torch.sqrt(torch.clamp(x.abs(), min=1e-12))


def _betas_case1(L, rho):
    """Columns [b11, b12, b13, b14] (the reference's find_betas_approx_1)."""
    x = _lstsq(L[..., [0, 1, 3, 6]], rho)
    b1 = torch.where(x[..., 0] < 0, 1e-3, _sqrt_abs(x[..., 0]))
    return torch.stack([b1, x[..., 1] / b1, x[..., 2] / b1, x[..., 3] / b1], -1)


def _betas_case2(L, rho):
    """Columns [b11, b12, b22] (find_betas_approx_2)."""
    x = _lstsq(L[..., [0, 1, 2]], rho)
    b1 = _sqrt_abs(x[..., 0])
    b2 = _sqrt_abs(x[..., 2]) * torch.sign(x[..., 1]) * torch.sign(x[..., 0] + 1e-30)
    z = torch.zeros_like(b1)
    return torch.stack([b1, b2, z, z], -1)


def _betas_case3(L, rho):
    """Columns [b11, b12, b22, b13, b23] (find_betas_approx_3)."""
    x = _lstsq(L[..., [0, 1, 2, 3, 4]], rho)
    b1 = _sqrt_abs(x[..., 0])
    b2 = _sqrt_abs(x[..., 2]) * torch.sign(x[..., 1])
    return torch.stack([b1, b2, x[..., 3] / b1, torch.zeros_like(b1)], -1)


def _products_and_jacobian(b):
    """The 10 beta products (..., 10) and their Jacobian (..., 10, 4), in
    _L6x10's order (the closed form of JAX's jacfwd)."""
    b1, b2, b3, b4 = b.unbind(-1)
    z = torch.zeros_like(b1)
    prods = torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3,
                         b1 * b4, b2 * b4, b3 * b4, b4 * b4], -1)
    D = torch.stack([
        torch.stack([b1 + b1, z, z, z], -1),
        torch.stack([b2, b1, z, z], -1),
        torch.stack([z, b2 + b2, z, z], -1),
        torch.stack([b3, z, b1, z], -1),
        torch.stack([z, b3, b2, z], -1),
        torch.stack([z, z, b3 + b3, z], -1),
        torch.stack([b4, z, z, b1], -1),
        torch.stack([z, b4, z, b2], -1),
        torch.stack([z, z, b4, b3], -1),
        torch.stack([z, z, z, b4 + b4], -1),
    ], -2)
    return prods, D


def _gauss_newton_betas(L, rho, betas, iters=5):
    """Refine the betas on the 6 distance constraints
    (PnPsolver::gauss_newton); a step that is not finite is not taken."""
    eye = torch.eye(4, dtype=L.dtype, device=L.device)
    b = betas
    for _ in range(iters):
        prods, D = _products_and_jacobian(b)
        r = (L @ prods[..., None])[..., 0] - rho               # (..., 6)
        J = L @ D                                              # (..., 6, 4)
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye
        db = _solve(JtJ, -(J.transpose(-1, -2) @ r[..., None]))[..., 0]
        ok = torch.isfinite(db).all(-1, keepdim=True)
        b = b + torch.where(ok, db, 0.0)
    return b


def _pose_from_betas(V, betas, alphas, pw):
    """Camera control points = sum beta_i v_i -> point depths -> rigid
    alignment (Horn, fixed scale). NaN where any input of the alignment
    is not finite (JAX's eigensolver returns NaN there)."""
    ccs = (V @ betas[..., None])[..., 0].reshape(V.shape[:-2] + (4, 3))
    pc = alphas @ ccs                                          # (..., n, 3)
    # positive depth (EPnP's sign ambiguity): flip if the mean z < 0
    flip = pc[..., 2].mean(-1) < 0
    pc = torch.where(flip[..., None, None], -pc, pc)
    ok = torch.isfinite(pc).flatten(-2).all(-1) & torch.isfinite(pw).flatten(-2).all(-1)
    m = ok[..., None, None]
    _, R, t = horn_sim3(torch.where(m, pc, 0.0), torch.where(m, pw, 0.0),
                        fix_scale=True)                        # pc ~ R pw + t
    return _nan_where_not(ok, R, t)


def _reproj_err(R, t, pw, uv, fx, fy, cx, cy):
    """Squared pixel error (..., n) of pw through x_cam = R pw + t."""
    pc = pw @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(pc[..., 2].abs() < 1e-9, 1e-9, pc[..., 2])
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2


def epnp_solve(pw, uv, K_mat, cw=None):
    """EPnP on (..., n, 3) world points and (..., n, 2) pixels. Returns
    (R (..., 3, 3), t (..., 3)) with x_cam = R x_world + t: the best of
    the three beta cases by reprojection error, case 1 unless another is
    strictly better (a NaN error never is). `cw` (..., 4, 3): the control
    points, None = `_control_points(pw)`. Their PCA directions have the
    sign the eigensolver gives, and under noise another sign is another
    (equally valid) estimate: the tests pass JAX's control points here to
    compare the rest of the solve."""
    fx, fy, cx, cy = K_mat[0, 0], K_mat[1, 1], K_mat[0, 2], K_mat[1, 2]
    if cw is None:
        cw = _control_points(pw)
    alphas = _barycentric(pw, cw)
    M = _build_M(alphas, uv, fx, fy, cx, cy)
    _, evecs = _eigh(M.transpose(-1, -2) @ M)   # ascending
    V = evecs[..., :, :4]                       # the 4 smallest
    L = _L6x10(V)
    rho = _rho(cw)

    best = None
    for case_fn in (_betas_case1, _betas_case2, _betas_case3):
        betas = _gauss_newton_betas(L, rho, case_fn(L, rho))
        R, t = _pose_from_betas(V, betas, alphas, pw)
        err = _reproj_err(R, t, pw, uv, fx, fy, cx, cy).sum(-1)
        if best is None:
            best = (err, R, t)
        else:
            take = err < best[0]
            best = (torch.where(take, err, best[0]),
                    torch.where(take[..., None, None], R, best[1]),
                    torch.where(take[..., None], t, best[2]))
    return best[1], best[2]


def epnp_ransac(pw, uv, valid, inv_sigma2, K_mat, *, generator=None, idx=None,
                n_hypotheses: int = 128, min_set: int = 4,
                chi2_th: float = 5.991):
    """Batched EPnP RANSAC (PnPsolver::iterate, src/PnPsolver.cc:166-306):
    `n_hypotheses` minimal sets from `sample_minimal_sets(valid,
    n_hypotheses, min_set, generator=generator, idx=idx)`, all solved at
    once, each scored on every row; the hypothesis with the most inliers
    (the first on a tie) wins. pw [N, 3], uv [N, 2], valid [N],
    inv_sigma2 [N]. Returns (R [3, 3], t [3], inliers [N], n_inliers) as
    device tensors; the caller refines on the inliers (pose_optimize, as
    the reference's ladder, src/Tracking.cc:908-948)."""
    sets = sample_minimal_sets(valid, n_hypotheses, min_set,
                               generator=generator, idx=idx)
    Rs, ts = epnp_solve(pw[sets], uv[sets], K_mat)             # [H, 3, 3], [H, 3]
    err = _reproj_err(Rs, ts, pw, uv, K_mat[0, 0], K_mat[1, 1], K_mat[0, 2],
                      K_mat[1, 2])                             # [H, N]
    inls = valid & (err * inv_sigma2 < chi2_th)
    counts = inls.sum(-1)
    b = torch.argmax(counts)                                   # the first maximum
    return Rs[b], ts[b], inls[b], counts[b]
