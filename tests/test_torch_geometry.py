"""The port's SE(3) maps and camera model against the JAX package's, on
the CPU, from the same numpy inputs (tests/test_geometry.py's SE3 and
camera cases, with the JAX package as the reference in place of the cv2
and scipy oracles, which the card machine lacks).

Tolerances and why:
- se3_identity, se3_rotation, se3_translation, distort, unproject,
  project (with and without distortion, |z| < 1e-9 included), K and the
  scene's camera model: equal bits (the same f32 operations in the same
  order, elementwise);
- se3_compose and se3_apply: 1e-6 relative plus 1e-7 absolute (a 4x4
  f32 product, its sums in another order);
- se3_exp and se3_log away from pi: 1e-5 absolute (f32 sin, cos and
  atan2 from two libraries), on both sides of theta^2 = 1e-8;
- the port's float64 round trip exp(log(T)): 1e-7 absolute;
- se3_log within 1e-3 of pi: 1e-4 absolute (the axis comes from the
  diagonal of (R + I) / 2, where an ulp of R moves it by ~1e-5 / theta);
- undistort_points(project(..., True)): 1e-4 pixels against JAX (eight
  fixed-point steps in f32), and the normalized round trip within JAX's
  own 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.geometry import camera as jcam
from orb_slam_tpu.geometry import se3 as jse3
from orb_slam_tpu.io.synthetic import SyntheticScene as JaxScene
from orb_slam_tpu_torch.convert import camera_from_numpy
from orb_slam_tpu_torch.geometry import camera as tcam
from orb_slam_tpu_torch.geometry import se3 as tse3
from orb_slam_tpu_torch.io.synthetic import SyntheticScene

CAM = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
           k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026)
T = torch.from_numpy


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                  b.view(np.int32) if b.dtype == np.float32 else b)


def near(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


def tangents(rng, theta2=None, n=64):
    """[n, 6] f32 tangents; with `theta2`, every rotation part has that
    squared angle."""
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    if theta2 is not None:
        phi = xi[:, 3:] / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
        xi[:, 3:] = (phi * np.sqrt(theta2)).astype(np.float32)
    return xi


def both_cams():
    return jcam.CameraModel.create(**CAM), tcam.CameraModel.create(**CAM)


# ----------------------------------------------------------------- SE(3)


@pytest.mark.parametrize("theta2", [None, 0.5e-8, 2e-8, 1e-12],
                         ids=["generic", "below_1e-8", "above_1e-8", "tiny"])
def test_se3_exp_log_against_jax(rng, theta2):
    xi = tangents(rng, theta2)
    Tj = jse3.se3_exp(jnp.asarray(xi))
    Tt = tse3.se3_exp(T(xi))
    near(Tt, Tj, 1e-5)
    # log of the same matrices: NaN where JAX's is NaN. Just above
    # theta^2 = 1e-8, f32 1 - cos(theta) is 0, so both packages divide by
    # B = 0 (ROADMAP C20); in float64 the port's round trip holds there too,
    # within 1e-7 (1 - A / (2 B) cancels to ~theta^2 / 12)
    log_t = tse3.se3_log(T(np.array(Tj)))
    near(log_t, jse3.se3_log(Tj), 1e-5)
    ok = torch.isfinite(log_t).all(1)
    assert bool(ok.all()) == (theta2 != 2e-8)
    near(tse3.se3_exp(log_t[ok]), Tt[ok], 1e-4)
    T64 = tse3.se3_exp(T(xi).double())
    near(tse3.se3_exp(tse3.se3_log(T64)), T64, 1e-7)


def test_se3_log_near_pi(rng):
    # rotations within 1e-3 of pi, from exact axis-angle matrices
    n = 32
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = np.pi - rng.uniform(1e-5, 9e-4, n)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K -= K.transpose(0, 2, 1)
    R = (np.eye(3) + np.sin(theta)[:, None, None] * K
         + (1 - np.cos(theta))[:, None, None] * (K @ K))
    Tm = np.tile(np.eye(4), (n, 1, 1))
    Tm[:, :3, :3] = R
    Tm[:, :3, 3] = rng.normal(size=(n, 3))
    Tm = Tm.astype(np.float32)
    got, want = tse3.se3_log(T(Tm)), jse3.se3_log(jnp.asarray(Tm))
    assert float(torch.linalg.norm(got[:, 3:], dim=1).min()) > np.pi - 1e-3
    near(got, want, 1e-4)


def test_se3_log_batched_leading_dims(rng):
    xi = tangents(rng, n=24).reshape(2, 3, 4, 6)
    Tt = tse3.se3_exp(T(xi))
    assert Tt.shape == (2, 3, 4, 4, 4)
    near(tse3.se3_log(Tt).reshape(-1, 6), tse3.se3_log(Tt.reshape(-1, 4, 4)), 0.0)
    assert tse3.se3_log(Tt.double()).dtype == torch.float64


def test_se3_compose_apply_against_jax(rng):
    xi1, xi2 = tangents(rng, n=16), tangents(rng, n=16)
    T1, T2 = np.asarray(jse3.se3_exp(jnp.asarray(xi1))), np.asarray(
        jse3.se3_exp(jnp.asarray(xi2)))
    near(tse3.se3_compose(T(T1), T(T2)), jse3.se3_compose(T1, T2), 1e-7, 1e-6)
    p = rng.normal(size=(16, 3)).astype(np.float32)
    near(tse3.se3_apply(T(T1), T(p)), jse3.se3_apply(jnp.asarray(T1), jnp.asarray(p)),
         1e-7, 1e-6)
    # a batch of points through one transform, and the inverse undoing it
    pts = rng.normal(size=(5, 16, 3)).astype(np.float32)
    out = tse3.se3_apply(T(T1[:1]), T(pts))
    near(out, jse3.se3_apply(jnp.asarray(T1[:1]), jnp.asarray(pts)), 1e-7, 1e-6)
    near(tse3.se3_apply(tse3.se3_inverse(T(T1[:1])), out), pts, 1e-5)


def test_se3_identity_rotation_translation(rng):
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        eye = tse3.se3_identity(dtype, device="cpu")
        assert eye.dtype == dtype and eye.device.type == "cpu"
        np.testing.assert_array_equal(eye.numpy(), np.eye(4))
    Tm = np.asarray(jse3.se3_exp(jnp.asarray(tangents(rng, n=8))))
    same_bits(tse3.se3_rotation(T(Tm)), jse3.se3_rotation(Tm))
    same_bits(tse3.se3_translation(T(Tm)), jse3.se3_translation(Tm))


def test_se3_identity_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tse3.se3_identity().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tse3.se3_identity()


# ---------------------------------------------------------------- camera


def points(rng, n=200):
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(1.0, 5.0, n)
    # depths at and around the clamp: 0, +-1e-10, +-1e-9 and just past it
    p[:8, 2] = np.float32([0.0, 1e-10, -1e-10, 1e-9, -1e-9, 5e-10, 2e-9, -3e-9])
    return p


@pytest.mark.parametrize("with_distortion", [False, True])
def test_project_against_jax(rng, with_distortion):
    jc, tc = both_cams()
    p = points(rng)
    got = tcam.project(tc, T(p), with_distortion=with_distortion)
    want = jcam.project(jc, jnp.asarray(p), with_distortion=with_distortion)
    assert got.shape == (len(p), 2) and got.dtype == torch.float32
    same_bits(got, want)


def test_distort_unproject_against_jax(rng):
    jc, tc = both_cams()
    xn = rng.uniform(-0.4, 0.4, (100, 2)).astype(np.float32)
    same_bits(tcam.distort(tc, T(xn)), jcam.distort(jc, jnp.asarray(xn)))
    uv = rng.uniform([0, 0], [640, 480], (100, 2)).astype(np.float32)
    same_bits(tcam.unproject(tc, T(uv)), jcam.unproject(jc, jnp.asarray(uv)))
    # batched over leading dimensions
    same_bits(tcam.distort(tc, T(xn.reshape(4, 25, 2))).reshape(100, 2),
              tcam.distort(tc, T(xn)))


def test_distort_undistort_roundtrip(rng):
    jc, tc = both_cams()
    xn = rng.uniform(-0.4, 0.4, (100, 2)).astype(np.float32)
    p = np.concatenate([xn, np.ones((100, 1), np.float32)], 1) * 3.0
    uv_t = tcam.project(tc, T(p), with_distortion=True)
    und_t = tcam.undistort_points(tc, uv_t, iters=20)
    und_j = jcam.undistort_points(jc, jcam.project(jc, jnp.asarray(p), True), iters=20)
    near(und_t, und_j, 1e-4)
    near(tcam.unproject(tc, und_t), xn, 1e-3)


def test_camera_K_and_create(rng):
    jc, tc = both_cams()
    K = tc.K
    assert K.dtype == torch.float32 and K.shape == (3, 3) and K.device.type == "cpu"
    same_bits(K, jc.K)
    for f in dataclasses.fields(tcam.CameraModel):
        v = getattr(tc, f.name)
        assert type(v) is (int if f.name in ("width", "height") else float)
        assert v == np.asarray(getattr(jc, f.name)).item()
    # a model from the constructor computes the same bits as one from create
    plain = tcam.CameraModel(**CAM)
    uv = rng.uniform([0, 0], [640, 480], (64, 2)).astype(np.float32)
    p = points(rng, 64)
    same_bits(tcam.undistort_points(plain, T(uv)), tcam.undistort_points(tc, T(uv)))
    same_bits(tcam.project(plain, T(p), True), tcam.project(tc, T(p), True))
    same_bits(plain.K, K)
    same_bits(tcam.undistorted_bounds(plain), tcam.undistorted_bounds(tc))
    # JAX's model as numpy scalars converts to the same model
    assert camera_from_numpy(
        {k: np.asarray(v) for k, v in jc._asdict().items()}) == tc


@pytest.mark.parametrize("dist", [(0.0, 0.0, 0.0, 0.0), (0.1, -0.05, 0.001, -0.002)])
def test_scene_camera_model(dist):
    kw = dict(n_points=50, width=320, height=240, fx=260.3, fy=259.1, cx=160.2,
              cy=119.7, dist=dist)
    jc, tc = JaxScene(**kw).camera_model(), SyntheticScene(**kw).camera_model()
    assert isinstance(tc, tcam.CameraModel)
    for f in dataclasses.fields(tcam.CameraModel):
        want = np.asarray(getattr(jc, f.name))
        assert getattr(tc, f.name) == want.item(), f.name
    same_bits(tc.K, jc.K)
