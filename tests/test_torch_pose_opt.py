"""Kernel K2's module against the JAX package.

`pose_gn_plain` (the port of `_gn_rounds`) is held against `_gn_rounds`
and against the Pallas kernel in interpret mode, for the main path's
schedule (4, 3, 2, 2) and the reference's (10, 10, 7, 5), with the JAX
test's tolerances (tests/test_solvers.py:243-247): pose atol 1e-4, at most
max(2, 1%) inlier flips. The geometry helpers are held at f32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.geometry import se3 as jse3
from orb_slam_tpu.geometry import so3 as jso3
from orb_slam_tpu.solvers import pose_opt as jpo
from orb_slam_tpu.solvers.pose_opt_pallas import pose_optimize_pallas
from orb_slam_tpu_torch.geometry import se3 as tse3
from orb_slam_tpu_torch.geometry import so3 as tso3
from orb_slam_tpu_torch.solvers import pose_opt as tpo

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def fixture(seed, N, pad=0):
    """The outlier fixture of tests/test_solvers.py:220-234; `pad` extra
    invalid rows stand for the main path's compaction padding."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                    rng.uniform(4, 10, N)], 1).astype(np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0.1, -0.05, 0.02]
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = (pc[:, :2] / pc[:, 2:3]) * 500.0 + [320, 240] + rng.normal(0, 1.0, (N, 2))
    uv[::7] += rng.normal(0, 40, uv[::7].shape)
    valid = rng.random(N) > 0.1
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 8, N))).astype(np.float32)
    if pad:
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
        uv = np.concatenate([uv, np.zeros((pad, 2))])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
        inv_s2 = np.concatenate([inv_s2, np.ones(pad, np.float32)])
    return pts, uv.astype(np.float32), inv_s2, valid


def check(T_a, in_a, T_b, in_b):
    np.testing.assert_allclose(np.asarray(T_a), np.asarray(T_b), atol=1e-4)
    n = len(np.asarray(in_a))
    assert int(np.sum(np.asarray(in_a) != np.asarray(in_b))) <= max(2, n // 100)


@pytest.mark.parametrize("iters", [(4, 3, 2, 2), (10, 10, 7, 5)])
@pytest.mark.parametrize("seed,N,pad", [(42, 300, 0), (7, 1000, 24)])
def test_plain_matches_gn_rounds_and_pallas(iters, seed, N, pad):
    pts, uv, inv_s2, valid = fixture(seed, N, pad)
    jargs = (jnp.eye(4), jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(inv_s2),
             jnp.asarray(valid), jnp.asarray(K))
    Tx, ix = jpo._gn_rounds(*jargs, iters=iters)
    Tp, ip, _ = pose_optimize_pallas(*jargs, iters=iters, interpret=True)
    targs = (torch.eye(4), torch.from_numpy(pts), torch.from_numpy(uv),
             torch.from_numpy(inv_s2), torch.from_numpy(valid), torch.from_numpy(K))
    Tt, it = tpo.pose_gn_plain(*targs, iters=iters)
    check(Tt.numpy(), it.numpy(), Tx, ix)
    check(Tt.numpy(), it.numpy(), Tp, ip)
    # the wrapper takes the plain path for CPU tensors
    Tw, iw, nw = tpo.pose_optimize(*targs, iters=iters)
    np.testing.assert_array_equal(Tw.numpy(), Tt.numpy())
    assert int(nw) == int(it.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_residuals_jac(seed):
    rng = np.random.default_rng(seed)
    pts, uv, _, _ = fixture(seed, 64)
    xi = rng.normal(0, 0.05, 6).astype(np.float32)
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    rj, Jj, zj = jpo._residuals_jac(jnp.asarray(T), jnp.asarray(pts),
                                    jnp.asarray(uv), jnp.asarray(K))
    rt, Jt, zt = tpo._residuals_jac(torch.from_numpy(T), torch.from_numpy(pts),
                                    torch.from_numpy(uv), torch.from_numpy(K))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.0, 1e-5, 0.3, 2.0])
def test_se3_so3_maps(scale):
    rng = np.random.default_rng(int(scale * 1e6) % 97)
    xi = (rng.normal(0, 1, (5, 6)) * scale).astype(np.float32)
    np.testing.assert_allclose(tse3.se3_exp(torch.from_numpy(xi)).numpy(),
                               np.asarray(jse3.se3_exp(jnp.asarray(xi))), atol=2e-6)
    np.testing.assert_allclose(tso3.so3_exp(torch.from_numpy(xi[:, 3:])).numpy(),
                               np.asarray(jso3.so3_exp(jnp.asarray(xi[:, 3:]))),
                               atol=2e-6)
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(tse3.se3_inverse(torch.from_numpy(T)).numpy(),
                               np.asarray(jse3.se3_inverse(jnp.asarray(T))), atol=1e-6)


def test_solve6_and_orthonormalize():
    rng = np.random.default_rng(3)
    A = rng.normal(0, 1, (6, 6)).astype(np.float32)
    H = (A @ A.T + 0.1 * np.eye(6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    np.testing.assert_allclose(
        tpo.solve6_cholesky(torch.from_numpy(H), torch.from_numpy(b)).numpy(),
        np.asarray(jpo.solve6_cholesky(jnp.asarray(H), jnp.asarray(b))),
        rtol=1e-4, atol=1e-5)
    T = np.array(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.5, 6).astype(np.float32))))
    T[:3, :3] += rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
    np.testing.assert_allclose(tpo.orthonormalize_pose(torch.from_numpy(T)).numpy(),
                               np.asarray(jpo.orthonormalize_pose(jnp.asarray(T))),
                               atol=1e-6)
