"""The port's quaternions, Horn's Sim3 and the trajectory errors against
the JAX package, on the CPU, from the same numpy inputs.

Tolerances and why: quaternion maps are a few f32 products, within 1e-6;
`horn_sim3` on the cases of tests/test_geometry.py:198-247 (exact,
fixed scale, weighted with outliers, batched) within 1e-5 of JAX and of
the truth within that test's own bounds (a 4x4 eigensolve in f32 on
another LAPACK call); `ate_rmse` and `rpe` within 1e-5 relative; the TUM
file written by the port reads back equal to the JAX writer's text.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from orb_slam_tpu.geometry import horn_sim3 as jax_horn
from orb_slam_tpu.geometry import so3 as jso3
from orb_slam_tpu.io import trajectory as jtraj
from orb_slam_tpu_torch.geometry import so3 as tso3
from orb_slam_tpu_torch.geometry.horn import horn_sim3
from orb_slam_tpu_torch.io import trajectory as ttraj

T = torch.from_numpy


def rotations(rng, n=64):
    R = ScipyRot.random(n, rng=rng).as_matrix().astype(np.float32)
    # the four branches of the Shepperd select, and the identity
    R[:4] = ScipyRot.from_rotvec(np.array(
        [[0, 0, 0], [np.pi - 1e-3, 0, 0], [0, np.pi - 1e-3, 0],
         [0, 0, np.pi - 1e-3]])).as_matrix().astype(np.float32)
    return R


def test_quaternions(rng):
    R = rotations(rng)
    q = tso3.rot_to_quat(T(R)).numpy()
    np.testing.assert_allclose(q, np.asarray(jso3.rot_to_quat(jnp.asarray(R))), atol=1e-6)
    assert (q[:, 3] >= 0).all()
    np.testing.assert_allclose(tso3.quat_to_rot(T(q)).numpy(),
                               np.asarray(jso3.quat_to_rot(jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(tso3.quat_to_rot(T(q)).numpy(), R, atol=1e-5)
    q2 = tso3.quat_normalize(T(rng.normal(size=(64, 4)).astype(np.float32))).numpy()
    np.testing.assert_allclose(
        tso3.quat_mul(T(q), T(q2)).numpy(),
        np.asarray(jso3.quat_mul(jnp.asarray(q), jnp.asarray(q2))), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(q2, axis=1), 1.0, atol=1e-6)


def horn_case(rng, case):
    """(P1, P2, weights, fix_scale, truth (s, R, t)) of
    tests/test_geometry.py's TestHorn cases."""
    if case == "batched":
        B, n = 8, 12
        P2 = rng.normal(size=(B, n, 3)).astype(np.float32)
        R = ScipyRot.random(B, rng=rng).as_matrix().astype(np.float32)
        s = rng.uniform(0.5, 2.0, size=B).astype(np.float32)
        t = rng.normal(size=(B, 3)).astype(np.float32)
        P1 = s[:, None, None] * np.einsum("bij,bnj->bni", R, P2) + t[:, None, :]
        return P1.astype(np.float32), P2, None, False, (s, R, t)
    n = 20
    P2 = rng.normal(size=(n, 3)).astype(np.float32)
    R = ScipyRot.random(rng=rng).as_matrix().astype(np.float32)
    s = {"exact": 2.3, "fix_scale": 1.0, "weighted": 1.5}[case]
    t = np.array([0.5, -1.0, 2.0], np.float32)
    P1 = (s * P2 @ R.T + t).astype(np.float32)
    w = None
    if case == "weighted":
        P1[-5:] += 100.0
        w = np.ones(n, np.float32)
        w[-5:] = 0.0
    return P1, P2, w, case == "fix_scale", (np.float32(s), R, t)


@pytest.mark.parametrize("case", ["exact", "fix_scale", "weighted", "batched"])
def test_horn_sim3(rng, case):
    P1, P2, w, fix, (s0, R0, t0) = horn_case(rng, case)
    s, R, t = horn_sim3(T(P1), T(P2), weights=None if w is None else T(w),
                        fix_scale=fix)
    js, jR, jt = jax_horn(jnp.asarray(P1), jnp.asarray(P2),
                          weights=None if w is None else jnp.asarray(w),
                          fix_scale=fix)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), s0, rtol=1e-3)
    np.testing.assert_allclose(R.numpy(), R0, atol=1e-3)
    np.testing.assert_allclose(t.numpy(), t0, atol=1e-2)
    if fix:
        assert float(s) == 1.0


def noisy_path(rng, n=40):
    """Ground-truth poses, and estimated centres: a scaled, rotated,
    shifted and noisy copy (a monocular estimate)."""
    T_cw = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T_cw[:, :3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.1, (n, 3))).as_matrix()
    T_cw[:, :3, 3] = np.cumsum(rng.normal(0, 0.1, (n, 3)), 0)
    gt = ttraj.camera_centers_from_cw(T_cw)
    R = ScipyRot.from_rotvec([0.2, -0.1, 0.3]).as_matrix()
    est = 0.37 * (gt - 1.0) @ R.T + rng.normal(0, 0.01, gt.shape)
    return T_cw, gt, est


def test_ate_rpe(rng):
    T_cw, gt, est = noisy_path(rng)
    np.testing.assert_allclose(ttraj.camera_centers_from_cw(T_cw),
                               jtraj.camera_centers_from_cw(T_cw), atol=1e-6)
    for with_scale in (True, False):
        r, al = ttraj.ate_rmse(est, gt, with_scale=with_scale)
        jr, jal = jtraj.ate_rmse(est, gt, with_scale=with_scale)
        assert r == pytest.approx(jr, rel=1e-5)
        np.testing.assert_allclose(al, jal, atol=1e-5)
    assert ttraj.ate_rmse(est, gt)[0] < 0.05 < ttraj.ate_rmse(est, gt, with_scale=False)[0]
    for delta in (1, 5):
        assert ttraj.rpe(est, gt, delta) == pytest.approx(jtraj.rpe(est, gt, delta),
                                                          rel=1e-6)


def test_tum_round_trip(rng, tmp_path):
    T_cw, _, _ = noisy_path(rng, 6)
    rows = []
    for i, Tm in enumerate(T_cw):
        T_wc = np.linalg.inv(Tm.astype(np.float64)).astype(np.float32)
        rows.append((3 * i, T_wc[:3, 3], tso3.rot_to_quat(T(T_wc[:3, :3].copy())).numpy()))
    ttraj.write_tum(tmp_path / "port.txt", rows)
    jtraj.write_tum(tmp_path / "jax.txt", rows)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    ts, pos, q = ttraj.read_tum(tmp_path / "port.txt")
    jts, jpos, jq = jtraj.read_tum(tmp_path / "jax.txt")
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(pos, np.stack([r[1] for r in rows]), atol=1e-6)
    np.testing.assert_allclose(q, np.stack([r[2] for r in rows]), atol=1e-6)
    ttraj.write_tum(tmp_path / "one.txt", rows[:1])
    assert ttraj.read_tum(tmp_path / "one.txt")[1].shape == (1, 3)
