"""The port's SO(3) log, Sim(3) geometry and Sim3 solvers against the JAX
package's, on the CPU, from the same numpy inputs.

Tolerances and why: so3_log, sim3_exp and sim3_log within 1e-5 (f32 ops
in another order), their branches included (theta under 1e-5, sigma under
1e-5, theta within 1e-3 of pi); sim3_ransac on JAX's minimal sets
(recomputed from its key, as solvers/sim3.py:45-47 draws them): s, R, t
within 1e-5 and the inlier flags equal; optimize_sim3 with and without
fix_scale within 1e-5, inliers equal; degenerate inputs (no valid row,
collinear points) give JAX's outputs, NaN where JAX's are NaN, and never
raise. The Jacobian of optimize_sim3 is forward-mode AD in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from orb_slam_tpu.geometry import sim3 as jsim3
from orb_slam_tpu.geometry.so3 import so3_log as jax_so3_log
from orb_slam_tpu.solvers import sim3 as jsolve
from orb_slam_tpu_torch.geometry import sim3 as tsim3
from orb_slam_tpu_torch.geometry.so3 import so3_exp, so3_log
from orb_slam_tpu_torch.solvers import sim3 as tsolve

K_MAT = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
T = torch.from_numpy


def near(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=tol, rtol=0)


def tangents(rng, n=64):
    """Sim3 tangents with rows in every branch of sim3_exp."""
    xi = rng.normal(0, 0.5, (n, 7)).astype(np.float32)
    xi[:8, 3:6] *= 1e-7          # theta -> 0
    xi[8:16, 6] = 1e-7           # sigma -> 0
    xi[16:20, 3:6] = 0.0         # theta = 0
    xi[20:24, 6] = 0.0           # sigma = 0
    xi[24:28, 3:7] = 0.0         # both
    return xi


@pytest.mark.parametrize("branch", ["generic", "small", "near_pi"])
def test_so3_log_matches_jax(branch):
    rng = np.random.default_rng(1)
    axis = rng.normal(size=(40, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = {"generic": rng.uniform(0.01, 3.0, 40), "small": rng.uniform(0, 5e-6, 40),
             "near_pi": np.pi - rng.uniform(0, 5e-4, 40)}[branch]
    R = so3_exp(T((axis * angle[:, None]).astype(np.float32)))
    near(so3_log(R).numpy(), jax_so3_log(jnp.asarray(R.numpy())), 1e-5)


def test_sim3_exp_and_log_match_jax():
    xi = tangents(np.random.default_rng(2))
    a = jsim3.sim3_exp(jnp.asarray(xi))
    b = tsim3.sim3_exp(T(xi))
    for x, y in zip(a, b):
        near(y.numpy(), x, 1e-5)
    near(tsim3.sim3_log(b).numpy(), jsim3.sim3_log(a), 1e-5)


def test_sim3_algebra_matches_jax():
    rng = np.random.default_rng(3)
    x1, x2 = tangents(rng, 16), tangents(rng, 16)
    g1j, g2j = jsim3.sim3_exp(jnp.asarray(x1)), jsim3.sim3_exp(jnp.asarray(x2))
    g1t, g2t = tsim3.sim3_exp(T(x1)), tsim3.sim3_exp(T(x2))
    p = rng.normal(size=(16, 3)).astype(np.float32)
    pairs = [(jsim3.sim3_compose(g1j, g2j), tsim3.sim3_compose(g1t, g2t)),
             (jsim3.sim3_inverse(g1j), tsim3.sim3_inverse(g1t))]
    for a, b in pairs:
        for x, y in zip(a, b):
            near(y.numpy(), x, 1e-5)
    near(tsim3.sim3_apply(g1t, T(p)).numpy(), jsim3.sim3_apply(g1j, jnp.asarray(p)), 1e-5)
    near(tsim3.sim3_to_se3(g1t).numpy(), jsim3.sim3_to_se3(g1j), 1e-5)
    st = tsim3.sim3_stack(g1t)
    near(st.numpy(), jsim3.sim3_stack(g1j), 1e-6)
    for x, y in zip(tsim3.sim3_unstack(st), g1t):
        assert torch.equal(x, y)
    s, R, t = tsim3.sim3_identity(device="cpu")
    assert float(s) == 1.0 and torch.equal(R, torch.eye(3)) and not t.any()


def sim3_problem(seed, n=300, noise=0.3, outliers=60, s_true=1.4):
    """tests/test_loop_solvers.py's problem at loop-closing size."""
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 8, n)], 1).astype(np.float32)
    R = ScipyRot.from_rotvec([0.05, 0.3, -0.1]).as_matrix().astype(np.float32)
    t = np.array([0.4, -0.2, 0.5], np.float32)
    p2 = ((p1 - t) / s_true) @ R
    uv1 = ((p1[:, :2] / p1[:, 2:3]) * [500, 500] + [320, 240]).astype(np.float32)
    uv2 = ((p2[:, :2] / p2[:, 2:3]) * [500, 500] + [320, 240]).astype(np.float32)
    uv1 += rng.normal(0, noise, uv1.shape).astype(np.float32)
    uv2 += rng.normal(0, noise, uv2.shape).astype(np.float32)
    bad = rng.choice(n, outliers, replace=False)
    p2[bad] += rng.uniform(1, 3, (outliers, 3)).astype(np.float32)
    valid = rng.random(n) > 0.1
    s2_1 = (1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    s2_2 = (1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    return p1, p2.astype(np.float32), uv1, uv2, valid, s2_1, s2_2


def jax_sets(valid, key, H=300):
    """The minimal sets jax's sim3_ransac draws from `key` (sim3.py:45-47)."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (H, len(valid))) + logits[None, :]
    return np.asarray(jax.lax.top_k(g, 3)[1])


def ransac_both(args, key, **kw):
    a = jsolve.sim3_ransac(*(jnp.asarray(x) for x in args), jnp.asarray(K_MAT), key, **kw)
    b = tsolve.sim3_ransac(*(T(np.asarray(x)) for x in args), T(K_MAT),
                           idx=jax_sets(args[4], key), **kw)
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_on_jax_sets(seed, fix_scale):
    args = sim3_problem(seed, s_true=1.0 if fix_scale else 1.4)
    a, b = ransac_both(args, jax.random.PRNGKey(seed), fix_scale=fix_scale)
    for x, y in zip(a[:3], b[:3]):
        near(y.numpy(), x, 1e-5)
    np.testing.assert_array_equal(b[3].numpy(), np.asarray(a[3]))
    assert int(b[4]) == int(a[4]) and int(a[4]) >= 150


@pytest.mark.parametrize("fix_scale", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_optimize_sim3_matches_jax(seed, fix_scale):
    s_true = 1.0 if fix_scale else 1.4
    p1, p2, uv1, uv2, valid, s2_1, s2_2 = sim3_problem(seed, outliers=30, s_true=s_true)
    R = ScipyRot.from_rotvec([0.05, 0.3, -0.1]).as_matrix().astype(np.float32)
    R0 = (ScipyRot.from_rotvec([0.004, -0.002, 0.003]).as_matrix() @ R).astype(np.float32)
    s0, t0 = np.float32(s_true * 1.01), np.array([0.41, -0.19, 0.51], np.float32)
    rest = (p1, p2, uv1, uv2, valid, 1.0 / s2_1, 1.0 / s2_2)
    a = jsolve.optimize_sim3(jnp.asarray(s0), jnp.asarray(R0), jnp.asarray(t0),
                             *(jnp.asarray(x) for x in rest), jnp.asarray(K_MAT),
                             fix_scale=fix_scale)
    b = tsolve.optimize_sim3(torch.tensor(s0), T(R0), T(t0), *(T(np.asarray(x)) for x in rest),
                             T(K_MAT), fix_scale=fix_scale)
    for x, y in zip(a[:3], b[:3]):
        near(y.numpy(), x, 1e-5)
    np.testing.assert_array_equal(b[3].numpy(), np.asarray(a[3]))
    assert int(b[4]) == int(a[4]) > 150
    if fix_scale:
        assert float(b[0]) == pytest.approx(float(s0), abs=1e-6)


def assert_same_or_both_nan(x, y, tol):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
    near(np.nan_to_num(x), np.nan_to_num(y), tol)


@pytest.mark.parametrize("case", ["all_invalid", "collinear"])
def test_degenerate_inputs_like_jax(case):
    p1, p2, uv1, uv2, valid, s2_1, s2_2 = sim3_problem(4, n=64, outliers=8)
    if case == "all_invalid":
        valid = np.zeros_like(valid)
    else:
        line = np.linspace(0, 1, len(p1), dtype=np.float32)[:, None]
        p1 = (np.array([0.1, 0.2, 5.0], np.float32) + line * [1.0, 0.5, 0.2]).astype(np.float32)
        p2 = (p1 * 0.7).astype(np.float32)
    args = (p1, p2, uv1, uv2, valid, s2_1, s2_2)
    a, b = ransac_both(args, jax.random.PRNGKey(9))
    for x, y in zip(a[:3], b[:3]):
        assert_same_or_both_nan(x, y.numpy(), 1e-4)
    np.testing.assert_array_equal(b[3].numpy(), np.asarray(a[3]))
    assert int(b[4]) == int(a[4])
    rest = (p1, p2, uv1, uv2, valid, 1.0 / s2_1, 1.0 / s2_2)
    s0, R0, t0 = np.float32(1.0), np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    a = jsolve.optimize_sim3(jnp.asarray(s0), jnp.asarray(R0), jnp.asarray(t0),
                             *(jnp.asarray(x) for x in rest), jnp.asarray(K_MAT))
    b = tsolve.optimize_sim3(torch.tensor(s0), T(R0), T(t0), *(T(np.asarray(x)) for x in rest),
                             T(K_MAT))
    for x, y in zip(a[:3], b[:3]):
        assert_same_or_both_nan(x, y.numpy(), 1e-4)
    np.testing.assert_array_equal(b[3].numpy(), np.asarray(a[3]))
