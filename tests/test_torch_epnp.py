"""The port's EPnP (orb_slam_tpu_torch/solvers/epnp.py) against the JAX
package's, on the CPU, from the same numpy inputs.

Eigenvectors are defined up to sign, and up to a basis within a repeated
eigenvalue. So the helpers downstream of an eigensolve are compared on
JAX's own control points and null space, injected; the control points
themselves up to the sign of each direction; whole solves by pose.
Tolerances and why: each helper within 1e-5 relative to its largest
entry, 1e-4 past the SVD least squares of the betas (f32 products summed
in another order); `epnp_solve`'s pose within 1e-4 on noise-free data;
with 0.5 px noise within 1e-3 on JAX's control points, and on the port's
own a fit as good as JAX's (the PCA signs are the eigensolver's: under
noise a flipped direction is another valid estimate, as on this problem). `epnp_ransac` on JAX's own sets (recomputed here from
JAX's key with `jax.random.gumbel` and `lax.top_k`, as epnp.py:209-212
draws them): with six-point sets, where each hypothesis is well posed,
the same best hypothesis and inlier count, the pose within 1e-3, >= 99%
of the inlier flags equal; with the four-point sets relocalisation draws,
whose null space is four-dimensional rounding noise, the winners' counts
within 1%, their inliers equal on >= 99% of rows and the poses refined on
them within 1e-3. Degenerate inputs never raise and give NaN where JAX
gives NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from orb_slam_tpu.solvers import epnp as je
from orb_slam_tpu_torch.solvers import epnp as te

K_MAT = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
T = torch.from_numpy


def make_pnp_problem(rng, n=50, noise=0.5, outliers=0):
    """tests/test_loop_solvers.py's problem."""
    pw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(4, 10, n)], 1).astype(np.float32)
    R = ScipyRot.from_rotvec([0.2, -0.3, 0.1]).as_matrix().astype(np.float32)
    t = np.array([0.5, -0.3, 1.0], np.float32)
    pc = pw @ R.T + t
    uv = (pc[:, :2] / pc[:, 2:3]) * [500, 500] + [320, 240]
    uv = (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)
    if outliers:
        bad = rng.choice(n, outliers, replace=False)
        uv[bad] += rng.uniform(30, 100, (outliers, 2))
    return pw, uv.astype(np.float32), R, t


def close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-6)
    assert np.abs(a - b).max() <= rel * scale, (np.abs(a - b).max(), scale)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    pw, uv, R, t = make_pnp_problem(rng, n=12, noise=0.5)
    cw = np.asarray(je._control_points(jnp.asarray(pw)))
    alphas = np.asarray(je._barycentric(jnp.asarray(pw), jnp.asarray(cw)))
    M = je._build_M(jnp.asarray(alphas), jnp.asarray(uv), 500.0, 500.0, 320.0, 240.0)
    V = np.asarray(jnp.linalg.eigh(M.T @ M)[1][:, :4])
    return pw, uv, cw, alphas, V


def test_control_points_up_to_sign(problem):
    pw, _, cw, _, _ = problem
    ct = te._control_points(T(pw)).numpy()
    close(ct[0], cw[0])
    for i in range(1, 4):
        d_t, d_j = ct[i] - ct[0], cw[i] - cw[0]
        sign = np.sign(np.dot(d_t, d_j))
        close(sign * d_t, d_j)


def test_helpers_on_injected_control_points_and_null_space(problem):
    pw, uv, cw, alphas, V = problem
    a_t = te._barycentric(T(pw), T(cw)).numpy()
    close(a_t, alphas)
    M_t = te._build_M(T(alphas), T(uv), 500.0, 500.0, 320.0, 240.0).numpy()
    close(M_t, je._build_M(jnp.asarray(alphas), jnp.asarray(uv), 500.0, 500.0, 320.0,
                           240.0))
    close(te._rho(T(cw)).numpy(), je._rho(jnp.asarray(cw)))
    L_j = np.asarray(je._L6x10(jnp.asarray(V)))
    close(te._L6x10(T(V)).numpy(), L_j)
    rho = np.asarray(je._rho(jnp.asarray(cw)))
    for ct, cj in ((te._betas_case1, je._betas_case1), (te._betas_case2, je._betas_case2),
                   (te._betas_case3, je._betas_case3)):
        b_j = np.asarray(cj(jnp.asarray(L_j), jnp.asarray(rho)))
        close(ct(T(L_j), T(rho)).numpy(), b_j, rel=1e-4)
        g_j = np.asarray(je._gauss_newton_betas(jnp.asarray(L_j), jnp.asarray(rho),
                                                jnp.asarray(b_j)))
        g_t = te._gauss_newton_betas(T(L_j), T(rho), T(b_j)).numpy()
        close(g_t, g_j, rel=1e-4)
        R_j, t_j = je._pose_from_betas(jnp.asarray(V), jnp.asarray(g_j),
                                       jnp.asarray(alphas), jnp.asarray(pw))
        R_t, t_t = te._pose_from_betas(T(V), T(g_j), T(alphas), T(pw))
        close(R_t.numpy(), R_j, rel=1e-4)
        close(t_t.numpy(), t_j, rel=1e-4)
        e_j = je._reproj_err(R_j, t_j, jnp.asarray(pw), jnp.asarray(uv), 500.0, 500.0,
                             320.0, 240.0)
        e_t = te._reproj_err(T(np.asarray(R_j)), T(np.asarray(t_j)), T(pw), T(uv), 500.0,
                             500.0, 320.0, 240.0)
        close(e_t.numpy(), e_j)


def test_lstsq_matches_jax_on_rank_deficient_systems():
    """The SVD least squares with JAX's cut-off, where a full-rank solver
    would differ: a zero column and two equal columns."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(6, 5)).astype(np.float32)
    A[:, 2] = 0.0
    A[:, 4] = A[:, 3]
    b = rng.normal(size=6).astype(np.float32)
    close(te._lstsq(T(A), T(b)).numpy(), jnp.linalg.lstsq(jnp.asarray(A), jnp.asarray(b))[0],
          rel=1e-4)


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_epnp_solve_pose(noise):
    """With exact data the control points' gauge does not matter: pose
    within 1e-4. With 0.5 px noise, on JAX's control points injected, pose
    within 1e-3; on the port's own (the PCA signs its eigensolver gives,
    which on this problem differ from JAX's LAPACK in one direction), a fit
    as good as JAX's: total reprojection error within 1.2x."""
    rng = np.random.default_rng(5)
    pw, uv, R, t = make_pnp_problem(rng, n=12, noise=noise)
    R_j, t_j = je.epnp_solve(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(K_MAT))
    R_t, t_t = te.epnp_solve(T(pw), T(uv), T(K_MAT))
    if noise == 0.0:
        assert np.abs(R_t.numpy() - np.asarray(R_j)).max() <= 1e-4
        assert np.abs(t_t.numpy() - np.asarray(t_j)).max() <= 1e-4
        assert np.abs(R_t.numpy() - R).max() < 5e-3
        return
    cw = np.asarray(je._control_points(jnp.asarray(pw)))
    R_c, t_c = te.epnp_solve(T(pw), T(uv), T(K_MAT), cw=T(cw))
    assert np.abs(R_c.numpy() - np.asarray(R_j)).max() <= 1e-3
    assert np.abs(t_c.numpy() - np.asarray(t_j)).max() <= 1e-3
    err = lambda R_, t_: float(te._reproj_err(T(np.asarray(R_)), T(np.asarray(t_)), T(pw),
                                              T(uv), 500.0, 500.0, 320.0, 240.0).sum())
    assert err(R_t, t_t) <= 1.2 * err(R_j, t_j)


def jax_sets(key, valid, n_hyp=128, k=4):
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n_hyp, len(valid))) + logits[None, :]
    return np.asarray(jax.lax.top_k(g, k)[1])


def jax_counts(pw, uv, valid, inv_s2, sets):
    """JAX's per-hypothesis inlier counts (the vmapped `one` of
    epnp_ransac)."""
    K = jnp.asarray(K_MAT)

    def one(idx):
        R, t = je.epnp_solve(pw[idx], uv[idx], K)
        err = je._reproj_err(R, t, pw, uv, K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        return jnp.sum(valid & (err * inv_s2 < 5.991))

    return np.asarray(jax.vmap(one)(jnp.asarray(sets)))


def port_counts(pw, uv, valid, inv_s2, sets):
    Rs, ts = te.epnp_solve(pw[sets], uv[sets], T(K_MAT))
    err = te._reproj_err(Rs, ts, pw, uv, 500.0, 500.0, 320.0, 240.0)
    return (valid & (err * inv_s2 < 5.991)).sum(-1).numpy()


def ransac_both(n, outliers, min_set):
    rng = np.random.default_rng(n)
    pw, uv, _, _ = make_pnp_problem(rng, n=n, noise=0.5, outliers=outliers)
    valid = rng.random(n) > 0.05
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    key = jax.random.PRNGKey(n)
    sets = jax_sets(key, valid, k=min_set)
    args_j = [jnp.asarray(a) for a in (pw, uv, valid, inv_s2, K_MAT)]
    args_t = [T(a) for a in (pw, uv, valid, inv_s2, K_MAT)]
    out_j = je.epnp_ransac(*args_j, key, min_set=min_set)
    out_t = te.epnp_ransac(*args_t, idx=sets, min_set=min_set)
    return args_j, args_t, sets, out_j, out_t


@pytest.mark.parametrize("n,outliers", [(60, 15), (1000, 300)])
def test_epnp_ransac_on_jax_sets(n, outliers):
    """Six-point sets, where the null space is one-dimensional and each
    hypothesis is well posed: the same best hypothesis and inlier count,
    the pose within 1e-3, the inliers equal on >= 99% of the rows."""
    args_j, args_t, sets, out_j, out_t = ransac_both(n, outliers, 6)
    c_j = jax_counts(*args_j[:4], sets)
    c_t = port_counts(*args_t[:4], T(sets))
    assert int(np.argmax(c_t)) == int(np.argmax(c_j))
    assert int(out_t[3]) == int(out_j[3]) == c_j.max()
    assert np.abs(out_t[0].numpy() - np.asarray(out_j[0])).max() <= 1e-3
    assert np.abs(out_t[1].numpy() - np.asarray(out_j[1])).max() <= 1e-3
    assert (out_t[2].numpy() == np.asarray(out_j[2])).mean() >= 0.99


@pytest.mark.parametrize("n,outliers", [(60, 15), (1000, 300)])
def test_epnp_ransac_minimal_sets_of_four(n, outliers):
    """Four-point sets, as relocalisation draws them: M is 8 x 12, so the
    four smallest eigenvalues of M'M are all rounding noise and the null
    space's basis, hence each hypothesis's beta approximations, is decided
    by the eigensolver (and so is the winner among equally good
    hypotheses). Held where relocalisation uses the result: the winners'
    inlier counts within 1%, their inliers equal on >= 99% of the rows, and
    pose_optimize from each winner on its inliers within 1e-3."""
    from orb_slam_tpu.solvers.pose_opt import pose_optimize as jax_po
    from orb_slam_tpu_torch.solvers.pose_opt import pose_optimize

    args_j, args_t, _, out_j, out_t = ransac_both(n, outliers, 4)
    assert abs(int(out_t[3]) - int(out_j[3])) <= 0.01 * int(out_j[3])
    assert (out_t[2].numpy() == np.asarray(out_j[2])).mean() >= 0.99

    def seed_pose(R, t):
        T0 = np.eye(4, dtype=np.float32)
        T0[:3, :3], T0[:3, 3] = np.asarray(R), np.asarray(t)
        return T0

    T_j = jax_po(jnp.asarray(seed_pose(*out_j[:2])), args_j[0], args_j[1], args_j[3],
                 out_j[2], args_j[4])[0]
    T_t = pose_optimize(T(seed_pose(*out_t[:2])), args_t[0], args_t[1], args_t[3],
                        out_t[2], args_t[4])[0]
    assert np.abs(T_t.numpy() - np.asarray(T_j)).max() <= 1e-3


def degenerate_inputs(kind):
    rng = np.random.default_rng(2)
    pw, uv, _, _ = make_pnp_problem(rng, n=40, noise=0.5)
    valid = np.ones(40, bool)
    if kind == "coplanar":
        pw[:, 2] = 6.0
    elif kind == "three valid":
        valid[3:] = False
    elif kind == "none valid":
        valid[:] = False
    elif kind == "zeros":
        pw[:] = 0.0
    return pw, uv, valid


@pytest.mark.parametrize("kind", ["coplanar", "three valid", "none valid", "zeros"])
def test_degenerate_inputs_never_raise(kind):
    """No raise; the finiteness of each output as JAX's; with fewer than 4
    valid rows no inlier; the same inlier count."""
    pw, uv, valid = degenerate_inputs(kind)
    inv_s2 = np.ones(len(pw), np.float32)
    key = jax.random.PRNGKey(9)
    sets = jax_sets(key, valid)
    out_j = je.epnp_ransac(*[jnp.asarray(a) for a in (pw, uv, valid, inv_s2, K_MAT)], key)
    out_t = te.epnp_ransac(T(pw), T(uv), T(valid), T(inv_s2), T(K_MAT), idx=sets)
    for a, b in zip(out_t[:2], out_j[:2]):
        np.testing.assert_array_equal(np.isfinite(a.numpy()), np.isfinite(np.asarray(b)))
    assert int(out_t[3]) == int(out_j[3])
    if valid.sum() < 4:
        assert int(out_t[3]) <= valid.sum()
    R_j, t_j = je.epnp_solve(*[jnp.asarray(a) for a in (pw[:4], uv[:4], K_MAT)])
    R_t, t_t = te.epnp_solve(T(pw[:4]), T(uv[:4]), T(K_MAT))
    np.testing.assert_array_equal(np.isfinite(R_t.numpy()), np.isfinite(np.asarray(R_j)))


def test_nan_input_gives_nan_not_a_raise():
    """A NaN point reaches every eigensolve and solve of one hypothesis:
    its pose is NaN, as in JAX, and the batch still solves the others."""
    rng = np.random.default_rng(4)
    pw, uv, _, _ = make_pnp_problem(rng, n=8, noise=0.0)
    batch = np.stack([pw[:4], pw[4:]])
    batch[0, 1, 0] = np.nan
    ub = np.stack([uv[:4], uv[4:]])
    R_t, t_t = te.epnp_solve(T(batch), T(ub), T(K_MAT))
    R_j, t_j = jax.vmap(je.epnp_solve, in_axes=(0, 0, None))(
        jnp.asarray(batch), jnp.asarray(ub), jnp.asarray(K_MAT))
    np.testing.assert_array_equal(np.isfinite(R_t.numpy()), np.isfinite(np.asarray(R_j)))
    assert not np.isfinite(R_t.numpy()[0]).any() and np.isfinite(R_t.numpy()[1]).all()
