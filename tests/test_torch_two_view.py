"""The port's two-view initialisation against the JAX package's, on the
CPU, from the same numpy inputs and the same minimal sets.

The sets: `jax.random` cannot be reproduced without JAX, so each case
draws JAX's sets with JAX's own `_sample_minimal_sets` and the key JAX's
`initialize_two_view` is given, and hands them to the port as `idx`.

Tolerances and why:
- H and F are defined up to scale and sign, and LAPACK may return a null
  vector of either sign: they are compared after scaling to unit norm
  with the largest entry positive. A null vector moves under rounding by
  about eps / gap, the gap being the distance of the smallest singular
  value to the next over the largest, so each minimal fit is held to
  1e-6 / gap (measured: at most 8.4e-8 / gap; 1.1e-4 for the one F
  sample whose gap is 1.6e-4), the refits over all inliers to 1e-4;
- scores and inlier masks of the same H or F: masks equal, scores within
  1e-4 relative (f32 sums in another order), or for H within 1e-7 x its
  condition number relative where that is more: the score inverts H in
  f32, whose relative error grows with the condition number (measured:
  one of the 200 H, condition 2.1e5, scores 1.2501 and 1.2514);
- `_check_rt` of the same (R, t): counts and masks equal, points within
  1e-3 relative of their distance (a 4x4 eigensolve per point);
- the decompositions as sets: every JAX (R, t) has a port (R, t) within
  1e-4, since a sign flip of a singular-vector pair permutes them;
- `initialize_two_view`: `success` and `used_homography` equal, the
  selected R and t within 1e-4, `is_triangulated` differing on at most
  0.5% of rows (a point on a gate's edge), the scenes of
  tests/test_solvers.py:34-94 and tests/test_edge_cases.py:51-66.
  Measured: translation R 3.2e-6, t 1.2e-5, planar (H) 1.8e-7 and 9.1e-6,
  no row of `is_triangulated` differing, the same n_good (249, 300).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from orb_slam_tpu.solvers import two_view as jtv
from orb_slam_tpu_torch.solvers import two_view as ttv

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def project(pts, R, t, noise, rng):
    pc = pts @ R.T + t
    uv = (pc[:, :2] / pc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    if noise:
        uv = uv + rng.normal(0, noise, uv.shape)
    return uv.astype(np.float32), pc[:, 2]


def scene(kind, seed=42):
    """(x1, x2, valid, key) of tests/test_solvers.py's scenes."""
    rng = np.random.default_rng(seed)
    n = 300
    if kind == "planar":
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                        np.full(n, 6.0)], 1).astype(np.float32)
        R2 = ScipyRot.from_rotvec([0.0, -0.04, 0.0]).as_matrix().astype(np.float32)
        t2 = np.array([-0.6, 0.0, 0.1], np.float32)
        uv1, _ = project(pts, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                         0.3, rng)
        uv2, _ = project(pts, R2, t2, 0.3, rng)
        return uv1, uv2, np.ones(n, bool), jax.random.PRNGKey(1)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(4.0, 10.0, n)], 1).astype(np.float32)
    if kind == "translation":
        R2 = ScipyRot.from_rotvec([0.02, -0.05, 0.01]).as_matrix().astype(np.float32)
        t2, noise, frac = np.array([-0.8, 0.1, 0.05], np.float32), 0.5, 0.15
    else:                                                   # pure rotation
        R2 = ScipyRot.from_rotvec([0.0, 0.1, 0.0]).as_matrix().astype(np.float32)
        t2, noise, frac = np.zeros(3, np.float32), 0.3, 0.0
    uv1, z1 = project(pts, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                      noise, rng)
    uv2, z2 = project(pts, R2, t2, noise, rng)
    n_out = int(frac * n)
    out = rng.choice(n, n_out, replace=False)
    uv2[out] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return uv1, uv2, (z1 > 0.1) & (z2 > 0.1), jax.random.PRNGKey(0)


def edge_case(kind):
    rng = np.random.default_rng(42)
    n = 64
    x1 = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    if kind == "too_few":
        x2 = rng.uniform(0, 640, (n, 2)).astype(np.float32)
        valid = np.zeros(n, bool)
        valid[:5] = True
        return x1, x2, valid, jax.random.PRNGKey(0)
    return x1, x1.copy(), np.zeros(n, bool), jax.random.PRNGKey(0)


def jax_sets(valid, key):
    return np.asarray(jtv._sample_minimal_sets(key, jnp.asarray(valid), 200, 8))


T = torch.from_numpy


def unit(M):
    """Unit norm, largest-magnitude entry positive, per matrix."""
    M = np.asarray(M, np.float64).reshape(-1, 9)
    M = M / np.linalg.norm(M, axis=1, keepdims=True)
    s = np.sign(M[np.arange(len(M)), np.abs(M).argmax(1)])
    return M * s[:, None]


@pytest.fixture(scope="module")
def fits():
    """JAX's and the port's 200 H and F minimal fits on the translation
    scene, in normalized coordinates, from the same sets."""
    x1, x2, valid, key = scene("translation")
    sets = jax_sets(valid, key)
    jn1, jT1 = jtv._normalize_points(jnp.asarray(x1), jnp.asarray(valid))
    jn2, jT2 = jtv._normalize_points(jnp.asarray(x2), jnp.asarray(valid))
    tn1, tT1 = ttv._normalize_points(T(x1), T(valid))
    tn2, tT2 = ttv._normalize_points(T(x2), T(valid))
    np.testing.assert_allclose(tn1.numpy(), np.asarray(jn1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tT2.numpy(), np.asarray(jT2), rtol=1e-6)
    s1, s2 = np.asarray(jn1)[sets], np.asarray(jn2)[sets]
    return dict(x1=x1, x2=x2, valid=valid, s1=s1, s2=s2, jT1=np.asarray(jT1), jT2=np.asarray(jT2),
                jH=np.asarray(jax.vmap(jtv._dlt_h)(jnp.asarray(s1), jnp.asarray(s2))),
                jF=np.asarray(jax.vmap(jtv._dlt_f)(jnp.asarray(s1), jnp.asarray(s2))),
                tH=ttv._dlt_h(T(s1), T(s2)).numpy(),
                tF=ttv._dlt_f(T(s1), T(s2)).numpy())


def test_minimal_fits_up_to_scale_and_sign(fits):
    for model, rows in (("H", ttv._h_rows), ("F", ttv._f_rows)):
        d = np.abs(unit(fits["t" + model]) - unit(fits["j" + model])).max(1)
        sv = torch.linalg.svdvals(rows(T(fits["s1"]), T(fits["s2"])).double()).numpy()
        # the null vector's gap: H has 9 singular values over 16 rows, F's
        # 8 rows leave a null space of one, its gap the smallest non-zero
        gap = ((sv[:, -2] - sv[:, -1]) if model == "H" else sv[:, -1]) / sv[:, 0]
        assert (d * gap).max() < 1e-6, (model, (d * gap).max())
    assert np.abs(np.linalg.det(fits["tF"].astype(np.float64))).max() < 1e-6


@pytest.mark.parametrize("model", ["H", "F"])
def test_scores_and_inliers(fits, model):
    x1, x2, valid = fits["x1"], fits["x2"], fits["valid"]
    jT1, jT2 = fits["jT1"], fits["jT2"]
    if model == "H":
        M = np.linalg.inv(jT2) @ fits["jH"] @ jT1
        jfn, tfn = jtv._score_h, ttv._score_h
    else:
        M = jT2.T @ fits["jF"] @ jT1
        jfn, tfn = jtv._score_f, ttv._score_f
    M = M.astype(np.float32)
    js, ji = jax.vmap(lambda m: jfn(m, jnp.asarray(x1), jnp.asarray(x2),
                                    jnp.asarray(valid)))(jnp.asarray(M))
    ts, ti = tfn(T(M), T(x1), T(x2), T(valid))
    rtol = 1e-4 * np.ones(len(M))
    if model == "H":
        rtol = np.maximum(rtol, 1e-7 * np.linalg.cond(M.astype(np.float64)))
    js = np.asarray(js)
    assert (np.abs(ts.numpy() - js) <= rtol * np.abs(js) + 1e-4).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.asarray(js).max() > 0


def test_score_h_of_a_singular_matrix_reads_zero():
    x1, _, valid, _ = scene("translation")
    H = np.zeros((2, 3, 3), np.float32)
    H[1] = np.eye(3)
    s, inl = ttv._score_h(T(H), T(x1), T(x1), T(valid))
    assert float(s[0]) == 0.0 and not inl[0].any() and float(s[1]) > 0


def test_refits(fits):
    x1, x2, valid = fits["x1"], fits["x2"], fits["valid"]
    n1, _ = ttv._normalize_points(T(x1), T(valid))
    n2, _ = ttv._normalize_points(T(x2), T(valid))
    w = valid.astype(np.float32)
    w[::3] = 0.0
    for jfn, tfn in ((jtv._refit_f, ttv._refit_f), (jtv._refit_h, ttv._refit_h)):
        j = np.asarray(jfn(jnp.asarray(n1.numpy()), jnp.asarray(n2.numpy()),
                           jnp.asarray(w)))
        t = tfn(n1, n2, T(w)).numpy()
        np.testing.assert_allclose(unit(t), unit(j), atol=1e-4)


def rt_set_matches(tR, tt, jR, jt, atol=1e-4):
    """Every JAX (R, t) has a port (R, t) within atol."""
    for R, t in zip(jR, jt):
        d = [max(np.abs(R - r).max(), np.abs(t - u).max()) for r, u in zip(tR, tt)]
        assert min(d) < atol, min(d)


def test_decompositions_as_sets(fits):
    x1, x2, valid = fits["x1"], fits["x2"], fits["valid"]
    F = (fits["jT2"].T @ fits["jF"][0] @ fits["jT1"]).astype(np.float32)
    E = (K.T @ F @ K).astype(np.float32)
    jR, jt = map(np.asarray, jtv._decompose_e(jnp.asarray(E)))
    tR, tt = (v.numpy() for v in ttv._decompose_e(T(E)))
    rt_set_matches(tR, tt, jR, jt)
    _, planar_x2, planar_valid, key = scene("planar")
    Hm = jtv._refit_h(*(jtv._normalize_points(jnp.asarray(a), jnp.asarray(planar_valid))[0]
                        for a in (scene("planar")[0], planar_x2)),
                      jnp.asarray(planar_valid.astype(np.float32)))
    Hm = np.asarray(Hm)
    jR, jt = map(np.asarray, jtv._decompose_h(jnp.asarray(Hm), jnp.asarray(K)))
    tR, tt = (v.numpy() for v in ttv._decompose_h(T(np.array(Hm)), T(K)))
    rt_set_matches(tR, tt, jR, jt)


def test_check_rt(fits):
    x1, x2, valid = fits["x1"], fits["x2"], fits["valid"]
    R = ScipyRot.from_rotvec([[0.02, -0.05, 0.01], [0.0, 0.3, 0.0]]).as_matrix()
    t = np.array([[-0.8, 0.1, 0.05], [0.8, -0.1, -0.05]])
    R, t = R.astype(np.float32), (t / np.linalg.norm(t, axis=1, keepdims=True)).astype(
        np.float32)
    inl = np.stack([valid, valid])
    jn, jp, jX, jg = jax.vmap(lambda r, u, i: jtv._check_rt(
        r, u, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(K), i))(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(inl))
    tn, tp, tX, tg = ttv._check_rt(T(R), T(t), T(x1), T(x2), T(K), T(inl))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4)
    g = np.asarray(jg)
    jX, tX = np.asarray(jX)[g], tX.numpy()[g]
    assert (np.linalg.norm(tX - jX, axis=1) / np.linalg.norm(jX, axis=1)).max() < 1e-3
    assert int(tn[0]) > 150 and int(tn[1]) < 50


CASES = {name: (lambda n=name: scene(n)) for name in ("translation", "planar",
                                                      "rotation")}
CASES.update({name: (lambda n=name: edge_case(n)) for name in ("too_few",
                                                               "all_invalid")})


@pytest.mark.parametrize("case", list(CASES))
def test_initialize_two_view(case):
    x1, x2, valid, key = CASES[case]()
    j = jtv.initialize_two_view(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                                jnp.asarray(K), key)
    t = ttv.initialize_two_view(T(x1), T(x2), T(valid), T(K),
                                idx=jax_sets(valid, key))
    assert bool(t.success) == bool(j.success)
    assert bool(t.used_homography) == bool(j.used_homography)
    assert np.isfinite(t.R21.numpy()).all()
    expect = {"translation": (True, False), "planar": (True, True)}
    if case in expect:
        assert (bool(t.success), bool(t.used_homography)) == expect[case]
        np.testing.assert_allclose(t.R21.numpy(), np.asarray(j.R21), atol=1e-4)
        np.testing.assert_allclose(t.t21.numpy(), np.asarray(j.t21), atol=1e-4)
        assert (t.is_triangulated.numpy() != np.asarray(j.is_triangulated)).mean() <= 0.005
        assert abs(int(t.n_good) - int(j.n_good)) <= max(1, int(0.005 * len(x1)))
    else:
        assert not bool(t.success)


def test_sampler_passes_injected_sets():
    valid = torch.ones(40, dtype=torch.bool)
    idx = np.arange(16, dtype=np.int32).reshape(2, 8)
    out = ttv.sample_minimal_sets(valid, 2, 8, idx=idx)
    assert out.dtype == torch.int64 and (out.numpy() == idx).all()


def test_sampler_draws_valid_distinct_rows_and_repeats():
    valid = torch.zeros(300, dtype=torch.bool)
    valid[torch.arange(3, 300, 7)] = True
    draw = lambda seed: ttv.sample_minimal_sets(
        valid, 200, 8, generator=torch.Generator().manual_seed(seed)).numpy()
    a = draw(0)
    assert a.shape == (200, 8) and valid.numpy()[a].all()
    assert all(len(set(r)) == 8 for r in a)
    np.testing.assert_array_equal(draw(0), a)
    assert (draw(1) != a).any()
    # fewer than 8 valid rows: the valid ones first, then the lowest invalid
    few = torch.zeros(20, dtype=torch.bool)
    few[[4, 9, 15]] = True
    s = ttv.sample_minimal_sets(few, 5, 8, generator=torch.Generator().manual_seed(0))
    for r in s.numpy():
        assert sorted(r[:3]) == [4, 9, 15] and list(r[3:]) == [0, 1, 2, 3, 5]
