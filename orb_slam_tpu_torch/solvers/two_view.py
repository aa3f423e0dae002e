"""Two-view monocular initialisation: batched H and F RANSAC, then the
reconstruction of the chosen model.

Port of orb_slam_tpu/solvers/two_view.py (all of it: `_normalize_points`
:37-52, `_dlt_h` :55-70, `_dlt_f` :73-87, `_score_h` :90-111, `_score_f`
:114-135, `_check_rt` :138-195, `_decompose_e` :198-211, `_decompose_h`
:214-270, `_refit_f` :273-290, `_refit_h` :293-306,
`_sample_minimal_sets` :309-318 and `initialize_two_view` :321-409; the
reference's Initializer, src/Initializer.cc). Camera 1 is the world
frame and the result is T21 = [R21 | t21]; the inputs are undistorted
pixels and K (sigma = 1 px, src/Tracking.cc:334).

The 200 homography and 200 fundamental hypotheses are batched
`torch.linalg` calls (SVD for the minimal fits, `eigh` for the refits),
as `jnp.linalg` is in JAX: no Pallas kernel and so no kernel of ours.
Where JAX gets NaN from a degenerate input (a singular H, the garbage an
empty match set feeds the solvers), the batched `torch.linalg` calls on
CUDA would raise instead, so: every inverse is `inv_ex` with the rows
whose `info` is not 0 set to NaN (their scores read 0, as in JAX); every
SVD and eigensolve gets its non-finite inputs zeroed and its outputs set
to NaN where an input was not finite. Nothing is caught and nothing runs
elsewhere. A sign flip of a singular vector pair permutes the 4 (E) or
8 (H) motion hypotheses among themselves; the set, the selected (R, t)
and its points do not change.

The minimal sets are Gumbel top-k draws from a seeded `torch.Generator`
(`sample_minimal_sets`); they cannot repeat `jax.random`'s draws, so the
parity tests pass JAX's sets in as `idx`. Matmuls need TF32 off (PyTorch's
default for float32 matmuls), in place of JAX's `precise_jit`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam_tpu_torch.geometry.triangulation import triangulate_dlt
from orb_slam_tpu_torch.ops.sort import top_k

CHI2_1D = 3.841
CHI2_2D = 5.991


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # bool scalar
    R21: torch.Tensor              # [3, 3]
    t21: torch.Tensor              # [3], unit norm
    points3d: torch.Tensor         # [N, 3] in camera 1 (the world)
    is_triangulated: torch.Tensor  # [N] bool
    used_homography: torch.Tensor  # bool scalar
    n_good: torch.Tensor           # int scalar


def _finite_in(x):
    """(x with non-finite entries zeroed, [...] True where the matrix was
    all finite) for a (..., m, n) input of a factorization."""
    ok = torch.isfinite(x).flatten(-2).all(-1)
    return torch.where(torch.isfinite(x), x, 0.0), ok


def _nan_where_not(ok, *outs):
    """Each output (..., ...) with NaN in the batch entries where ok is
    False."""
    res = []
    for o in outs:
        m = ok.reshape(ok.shape + (1,) * (o.ndim - ok.ndim))
        res.append(torch.where(m, o, float("nan")))
    return res


def _svd(A, full_matrices=True):
    A0, ok = _finite_in(A)
    u, s, vh = torch.linalg.svd(A0, full_matrices=full_matrices)
    return _nan_where_not(ok, u, s, vh)


def _eigh(G):
    G0, ok = _finite_in(G)
    w, V = torch.linalg.eigh(G0)
    return _nan_where_not(ok, w, V)


def _inv(A):
    """Batched inverse; NaN where the matrix is singular or not finite
    (JAX's CPU inverse returns inf/NaN there)."""
    A0, ok = _finite_in(A)
    Ainv, info = torch.linalg.inv_ex(A0)
    return _nan_where_not(ok & (info == 0), Ainv)[0]


def _normalize_points(xy, valid):
    """Mean and mean-absolute-deviation normalisation over the valid rows
    (Initializer.cc:747-793). Returns (normalized xy, T [3, 3] raw ->
    normalized)."""
    w = valid.to(xy.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (xy * w[:, None]).sum(0) / n
    mad = ((xy - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp(mad, min=1e-8)
    xn = (xy - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return xn, T


def _h_rows(x1, x2):
    """The two DLT rows of x2 ~ H21 x1 per correspondence, (..., 2n, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    return torch.cat([r1, r2], -2)


def _f_rows(x1, x2):
    """The epipolar row of x2' F21 x1 = 0 per correspondence, (..., n, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o],
                       -1)


def _rank2(Fpre):
    """The nearest rank-2 matrix: the smallest singular value zeroed."""
    u, s, vh = _svd(Fpre, full_matrices=False)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return (u * s[..., None, :]) @ vh


def _dlt_h(x1, x2):
    """8-point homography DLT (Initializer.cc:224-260), batched: x1, x2
    (..., 8, 2) normalized. Returns H21 (..., 3, 3), x2 ~ H21 x1."""
    _, _, vh = _svd(_h_rows(x1, x2))
    return vh[..., -1, :].reshape(vh.shape[:-2] + (3, 3))


def _dlt_f(x1, x2):
    """Normalized 8-point fundamental (Initializer.cc:262-301), batched,
    rank 2 enforced. Returns F21 (..., 3, 3), x2' F21 x1 = 0."""
    _, _, vh = _svd(_f_rows(x1, x2))
    return _rank2(vh[..., -1, :].reshape(vh.shape[:-2] + (3, 3)))


def _transfer(H, a, b):
    """Squared distance of b to H a, (...) hypotheses over N points."""
    H = H[..., None, :, :]
    den = H[..., 2, 0] * a[:, 0] + H[..., 2, 1] * a[:, 1] + H[..., 2, 2]
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    px = (H[..., 0, 0] * a[:, 0] + H[..., 0, 1] * a[:, 1] + H[..., 0, 2]) / den
    py = (H[..., 1, 0] * a[:, 0] + H[..., 1, 1] * a[:, 1] + H[..., 1, 2]) / den
    return (b[:, 0] - px) ** 2 + (b[:, 1] - py) ** 2


def _score_h(H21, x1, x2, valid, sigma2: float = 1.0):
    """Symmetric transfer chi2 score (Initializer.cc:303-390), batched
    over H21 (..., 3, 3). Returns (score (...), inlier (..., N))."""
    chi1 = _transfer(_inv(H21), x2, x1) / sigma2
    chi2 = _transfer(H21, x1, x2) / sigma2
    in1, in2 = chi1 < CHI2_2D, chi2 < CHI2_2D
    score = (torch.where(in1 & valid, CHI2_2D - chi1, 0.0)
             + torch.where(in2 & valid, CHI2_2D - chi2, 0.0)).sum(-1)
    return score, in1 & in2 & valid


def _epi(F, a, b):
    """Squared distance of b to the epipolar line F a."""
    F = F[..., None, :, :]
    la = F[..., 0, 0] * a[:, 0] + F[..., 0, 1] * a[:, 1] + F[..., 0, 2]
    lb = F[..., 1, 0] * a[:, 0] + F[..., 1, 1] * a[:, 1] + F[..., 1, 2]
    lc = F[..., 2, 0] * a[:, 0] + F[..., 2, 1] * a[:, 1] + F[..., 2, 2]
    num = la * b[:, 0] + lb * b[:, 1] + lc
    return num * num / torch.clamp(la * la + lb * lb, min=1e-12)


def _score_f(F21, x1, x2, valid, sigma2: float = 1.0):
    """Epipolar chi2 score (Initializer.cc:392-466), gated at the 1-dof
    threshold and scored from the 2-dof one, batched over F21."""
    chi1 = _epi(F21, x1, x2) / sigma2
    chi2 = _epi(F21.transpose(-1, -2), x2, x1) / sigma2
    in1, in2 = chi1 < CHI2_1D, chi2 < CHI2_1D
    score = (torch.where(in1 & valid, CHI2_2D - chi1, 0.0)
             + torch.where(in2 & valid, CHI2_2D - chi2, 0.0)).sum(-1)
    return score, in1 & in2 & valid


def _check_rt(R, t, x1, x2, K, inlier, sigma2: float = 1.0):
    """Cheirality, reprojection and parallax gates of (R, t) hypotheses
    (Initializer.cc:796-905), batched: R (H, 3, 3), t (H, 3), inlier
    (H, N); x1, x2 pixels. Returns (n_good (H,), parallax_deg (H,): the
    min(50, n_good)-th largest parallax among the good points,
    points3d (H, N, 3), good (H, N))."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    Hn, N = R.shape[0], x1.shape[0]
    xn1 = torch.stack([(x1[:, 0] - cx) / fx, (x1[:, 1] - cy) / fy], -1)
    xn2 = torch.stack([(x2[:, 0] - cx) / fx, (x2[:, 1] - cy) / fy], -1)
    P1 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device),
                    torch.zeros((3, 1), dtype=R.dtype, device=R.device)], 1)
    P2 = torch.cat([R, t[..., None]], -1)                     # (H, 3, 4)
    X = triangulate_dlt(xn1.expand(Hn, N, 2), xn2.expand(Hn, N, 2),
                        P1.expand(Hn, N, 3, 4),
                        P2[:, None].expand(Hn, N, 3, 4))
    finite = torch.isfinite(X).all(-1)
    X = torch.where(finite[..., None], X, 0.0)

    C2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]          # (H, 3)
    r1 = X
    r2 = X - C2[:, None, :]
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    cos_par = (r1 * r2).sum(-1) / torch.clamp(n1 * n2, min=1e-12)

    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = Xc2[..., 2]
    depth_ok = (z1 > 0) & (z2 > 0)
    z1s = torch.where(z1 == 0, 1e-12, z1)
    z2s = torch.where(z2 == 0, 1e-12, z2)
    e1 = ((fx * X[..., 0] / z1s + cx - x1[:, 0]) ** 2
          + (fy * X[..., 1] / z1s + cy - x1[:, 1]) ** 2)
    e2 = ((fx * Xc2[..., 0] / z2s + cx - x2[:, 0]) ** 2
          + (fy * Xc2[..., 1] / z2s + cy - x2[:, 1]) ** 2)
    reproj_ok = (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)
    good = inlier & finite & depth_ok & reproj_ok & (cos_par < 0.99998)
    n_good = good.sum(-1)

    deg = torch.rad2deg(torch.arccos(torch.clamp(cos_par, -1.0, 1.0)))
    deg = torch.where(good, deg, 0.0)
    deg_sorted = torch.sort(deg, -1, descending=True).values
    idx = torch.clamp(torch.clamp(n_good, min=1).clamp(max=50) - 1, 0, N - 1)
    parallax = torch.gather(deg_sorted, -1, idx[:, None])[:, 0]
    return n_good, parallax, X, good


def _decompose_e(E):
    """The 4 motions of an essential matrix (Initializer.cc:907-927).
    Returns Rs (4, 3, 3), ts (4, 3) unit."""
    u, _, vh = _svd(E, full_matrices=False)
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vh
    R2 = u @ W.T @ vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H21, K):
    """Faugeras' 8 motions of a homography (Initializer.cc:570-730).
    Returns Rs (8, 3, 3), ts (8, 3) unit."""
    A = _inv(K) @ H21 @ K
    U, w, Vt = _svd(A, full_matrices=False)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    prod = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    # d' = d2
    den_p = torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / den_p
    st = torch.stack([prod / den_p, -prod / den_p, -prod / den_p,
                      prod / den_p])
    # d' = -d2
    den_n = torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / den_n
    sp = torch.stack([prod / den_n, -prod / den_n, -prod / den_n,
                      prod / den_n])
    zero, one = torch.zeros_like(ct).expand(4), torch.ones_like(ct).expand(4)
    ctv, cpv = ct.expand(4), cp.expand(4)
    Rp_pos = torch.stack([torch.stack([ctv, zero, -st], -1),
                          torch.stack([zero, one, zero], -1),
                          torch.stack([st, zero, ctv], -1)], -2)
    Rp_neg = torch.stack([torch.stack([cpv, zero, sp], -1),
                          torch.stack([zero, -one, zero], -1),
                          torch.stack([sp, zero, -cpv], -1)], -2)
    tp_pos = torch.stack([x1s, zero, -x3s], -1) * (d1 - d3)
    tp_neg = torch.stack([x1s, zero, x3s], -1) * (d1 + d3)
    Rs = s * U @ torch.cat([Rp_pos, Rp_neg]) @ Vt
    ts = (U @ torch.cat([tp_pos, tp_neg])[..., None])[..., 0]
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    return Rs, ts


def _refit_f(x1, x2, w):
    """Least-squares fundamental over the weighted inliers (w in {0, 1}):
    the smallest eigenvector of the [9, 9] Gram matrix of the DLT rows,
    rank 2 enforced. JAX's improvement over the reference, which
    decomposes the best minimal model directly (Initializer.cc:468-486)."""
    A = _f_rows(x1, x2)
    G = torch.einsum("n,ni,nj->ij", w, A, A)
    _, V = _eigh(G)
    return _rank2(V[:, 0].reshape(3, 3))


def _refit_h(x1, x2, w):
    """Least-squares homography over the weighted inliers (as _refit_f)."""
    A = _h_rows(x1, x2)
    G = torch.einsum("n,ni,nj->ij", torch.cat([w, w]), A, A)
    _, V = _eigh(G)
    return V[:, 0].reshape(3, 3)


def sample_minimal_sets(valid, n_hyp: int, k: int = 8, *, generator=None,
                        idx=None):
    """[n_hyp, k] int64 row indices of minimal sets: `idx` as given when
    it is not None, else a Gumbel top-k draw from the rows where `valid`
    holds (no row twice within a set, the reference's per-set no-reuse
    sampling, Initializer.cc:78-95), from `generator` (a torch.Generator
    on valid's device; None = the global one). Invalid rows have logit
    -inf, so with fewer than k valid rows the set ends in the lowest
    invalid rows (ops/sort.top_k's tie order, as `lax.top_k`)."""
    if idx is not None:
        if not torch.is_tensor(idx):
            idx = torch.from_numpy(np.array(idx, np.int64))
        return idx.to(valid.device, torch.int64)
    n = valid.shape[0]
    u = torch.rand((n_hyp, n), generator=generator, device=valid.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u)) + torch.where(valid, 0.0, float("-inf"))
    return top_k(g, k)[1]


def initialize_two_view(x1, x2, valid, K, *, generator=None, idx=None,
                        n_hypotheses: int = 200, sigma: float = 1.0,
                        min_triangulated: int = 50,
                        min_parallax_deg: float = 1.0) -> TwoViewResult:
    """The whole two-view bootstrap (Initializer::Initialize,
    src/Initializer.cc:44-222, and Reconstruct{F,H}). x1, x2 [N, 2]
    undistorted pixels of the matches, valid [N] bool, K [3, 3]; the
    minimal sets from `sample_minimal_sets(valid, n_hypotheses, 8,
    generator=generator, idx=idx)`. Returns a TwoViewResult of device
    tensors; nothing here reads the device."""
    sigma2 = sigma * sigma
    N = x1.shape[0]
    xn1_all, T1 = _normalize_points(x1, valid)
    xn2_all, T2 = _normalize_points(x2, valid)
    T2inv = _inv(T2)

    sets = sample_minimal_sets(valid, n_hypotheses, 8, generator=generator,
                               idx=idx)
    Hn = _dlt_h(xn1_all[sets], xn2_all[sets])                 # [H, 3, 3]
    Fn = _dlt_f(xn1_all[sets], xn2_all[sets])
    H21s = T2inv @ Hn @ T1
    F21s = T2.T @ Fn @ T1
    h_scores, h_inliers = _score_h(H21s, x1, x2, valid, sigma2)
    f_scores, f_inliers = _score_f(F21s, x1, x2, valid, sigma2)
    bh, bf = torch.argmax(h_scores), torch.argmax(f_scores)   # first maximum
    SH, SF = h_scores[bh], f_scores[bf]
    H21, inH = H21s[bh], h_inliers[bh]
    F21, inF = F21s[bf], f_inliers[bf]

    # two rounds of refit on the inliers and re-gate (normalized coords)
    for _ in range(2):
        F21 = T2.T @ _refit_f(xn1_all, xn2_all, inF.to(x1.dtype)) @ T1
        _, inF = _score_f(F21, x1, x2, valid, sigma2)
        H21 = T2inv @ _refit_h(xn1_all, xn2_all, inH.to(x1.dtype)) @ T1
        _, inH = _score_h(H21, x1, x2, valid, sigma2)

    RH = SH / torch.clamp(SH + SF, min=1e-12)
    use_h = RH > 0.40                     # Initializer.cc:110-116

    # both reconstructions, the selection at the end (no host branch)
    Rs_f, ts_f = _decompose_e(K.T @ F21 @ K)
    Rs_h, ts_h = _decompose_h(H21, K)
    Rs = torch.cat([Rs_f, Rs_h])                              # [12, 3, 3]
    ts = torch.cat([ts_f, ts_h])
    inliers_per = torch.cat([inF.expand(4, N), inH.expand(8, N)])
    hyp_active = torch.cat([(~use_h).expand(4), use_h.expand(8)])
    n_goods, parallaxes, Xs, goods = _check_rt(Rs, ts, x1, x2, K,
                                               inliers_per, sigma2)
    n_goods = torch.where(hyp_active, n_goods, -1)

    best = torch.argmax(n_goods)
    n_best = n_goods[best]
    n_second = n_goods.scatter(0, best[None], -1).max()
    n_inliers = torch.where(use_h, inH, inF).sum()
    n_min = torch.clamp((0.9 * n_inliers.to(torch.float32)).to(torch.int64),
                        min=min_triangulated)
    # uniqueness: the runner-up under 0.75 of the best (the stricter of the
    # reference's H and F factors, applied to both)
    success = ((n_best >= n_min)
               & (n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32))
               & (parallaxes[best] > min_parallax_deg))
    return TwoViewResult(success=success, R21=Rs[best], t21=ts[best],
                         points3d=Xs[best], is_triangulated=goods[best],
                         used_homography=use_h, n_good=n_best)
