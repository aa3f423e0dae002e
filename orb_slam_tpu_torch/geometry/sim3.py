"""Sim(3): similarity transforms (scale, rotation, translation).

Port of orb_slam_tpu/geometry/sim3.py (all of it: `sim3_identity`,
`sim3_from_srt`, `sim3_compose`, `sim3_inverse`, `sim3_apply`,
`sim3_to_se3`, `sim3_exp` with its sigma -> 0 and theta -> 0 limits,
`sim3_log`, `sim3_stack`, `sim3_unstack`); the reference's g2o::Sim3
(Thirdparty/g2o/g2o/types/sim3.h). A Sim3 is a tuple (s (...,), R (..., 3,
3), t (..., 3)); the tangent is (..., 7) = [rho(3), phi(3), sigma(1)], g2o's
order. Batched over leading dimensions, and written for torch.func's
jacfwd and vmap (no in-place writes, nothing read on the host).

`sim3_log` solves Wm rho = t. `jnp.linalg.solve` returns NaN for a
singular or non-finite Wm where `torch.linalg.solve` raises, so the solve
is `solve_ex` with NaN written where it failed, as solvers/epnp.py does.
"""

from __future__ import annotations

import torch

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.geometry.se3 import se3_from_rt
from orb_slam_tpu_torch.geometry.so3 import _hat, so3_exp, so3_log


def sim3_identity(dtype=torch.float32, device="cuda"):
    """The identity Sim3 on `device` (the card unless the caller names
    another)."""
    device = require_device(device)
    return (torch.ones((), dtype=dtype, device=device),
            torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def sim3_from_srt(s, R, t):
    return (torch.as_tensor(s, dtype=R.dtype, device=R.device), R, t)


def sim3_compose(g1, g2):
    """g1 o g2: x -> s1 R1 (s2 R2 x + t2) + t1."""
    s1, R1, t1 = g1
    s2, R2, t2 = g2
    return (s1 * s2, R1 @ R2, s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1)


def sim3_inverse(g):
    s, R, t = g
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / s
    return (sinv, Rt, -sinv[..., None] * (Rt @ t[..., None])[..., 0])


def sim3_apply(g, p):
    s, R, t = g
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def sim3_to_se3(g):
    """[R | t / s], the SE3 recovered after the essential graph
    (src/Optimizer.cc:740-748)."""
    s, R, t = g
    return se3_from_rt(R, t / s[..., None])


def sim3_exp(xi):
    """Tangent (..., 7) [rho, phi, sigma] -> (s, R, t), t = Wm rho with
    Wm = A I + B W + C W^2 and the scale-coupled coefficients."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + 1e-24)
    W = _hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)

    sig = sigma
    one = torch.ones_like(sig)      # not 1.0: see so3_exp
    small_sig = sig.abs() < 1e-5
    small_th = theta < 1e-5
    safe_sig = torch.where(small_sig, one, sig)
    safe_th = torch.where(small_th, one, theta)
    safe_th2 = torch.where(small_th, one, theta2)

    A = torch.where(small_sig, 1.0 + sig / 2.0 + sig * sig / 6.0,
                    (s - 1.0) / safe_sig)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = safe_sig * safe_sig + safe_th2
    # generic: sigma != 0 and theta != 0
    a_g = s * sin_t
    b_g = s * cos_t
    B_g = (a_g * safe_sig + (1.0 - b_g) * safe_th) / (safe_th * denom)
    C_g = (A - ((b_g - 1.0) * safe_sig + a_g * safe_th) / denom) / safe_th2
    # sigma -> 0
    B_s0 = (1.0 - cos_t) / safe_th2
    C_s0 = (safe_th - sin_t) / (safe_th2 * safe_th)
    # theta -> 0
    B_t0 = torch.where(small_sig, 0.5 + sig / 6.0,
                       ((safe_sig - 1.0) * s + 1.0) / (safe_sig * safe_sig))
    C_t0 = torch.where(
        small_sig, 1.0 / 6.0 + sig / 24.0,
        (s * (0.5 * safe_sig * safe_sig - safe_sig + 1.0) - 1.0)
        / (safe_sig * safe_sig * safe_sig))
    B = torch.where(small_th, B_t0, torch.where(small_sig, B_s0, B_g))
    C = torch.where(small_th, C_t0, torch.where(small_sig, C_s0, C_g))
    Wm = A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * (W @ W)
    t = (Wm @ rho[..., None])[..., 0]
    return (s, R, t)


def _solve_nan(A, b):
    """jnp.linalg.solve(A, b): solve_ex, NaN where the factorization failed
    or A was not finite."""
    ok = torch.isfinite(A).flatten(-2).all(-1)
    x, info = torch.linalg.solve_ex(torch.where(torch.isfinite(A), A, torch.zeros_like(A)), b)
    good = (ok & (info == 0)).reshape(ok.shape + (1,) * (x.ndim - ok.ndim))
    return torch.where(good, x, torch.full_like(x, float("nan")))


def sim3_log(g):
    """(s, R, t) -> tangent (..., 7), the inverse of sim3_exp: Wm is
    rebuilt column by column (sim3_exp of the basis rho vectors) and
    Wm rho = t solved."""
    s, R, t = g
    sigma = torch.log(s)
    phi = so3_log(R)
    eye = torch.eye(3, dtype=t.dtype, device=t.device).expand(
        phi.shape[:-1] + (3, 3))
    cols = [sim3_exp(torch.cat([eye[..., i], phi, sigma[..., None]], -1))[2]
            for i in range(3)]
    Wm = torch.stack(cols, -1)
    rho = _solve_nan(Wm, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)


def sim3_stack(g):
    """(s, R, t) -> (..., 13) [s, R.flat(9), t(3)]."""
    s, R, t = g
    return torch.cat([s[..., None], R.reshape(R.shape[:-2] + (9,)), t], -1)


def sim3_unstack(a):
    return (a[..., 0], a[..., 1:10].reshape(a.shape[:-1] + (3, 3)), a[..., 10:13])
