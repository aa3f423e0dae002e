"""Bundle adjustment against the JAX package's CPU branches.

The map is a live JAX system's after 12 frames of the oracle-feature
sequence of tests/test_system_vo.py (4 keyframes, 222 points, 3 of them
seen by one keyframe), as tests/test_parallel.py:141-166 takes it; 3% of
the observations of points seen by at least 3 keyframes are then thrown 25
px off, so the solver has real steps and a non-empty outlier mask. The
single solver step optimizes the points with at least two observations in
the table: a point seen once has a 3x3 block of rank 2 plus the damping
(condition ~1e8, past f32), whose inverses from LAPACK and from XLA differ
in the first digit and feed the camera system through the Schur term (with
the 3 such points in, one step's poses differ by 3.0e-4 and its points by
9.4e-3). Whole `bundle_adjust` runs are compared on both point sets,
the second every live point, as the mapping path optimizes them: the LM
takes only the steps that lower the cost, and the runs agree (measured:
poses within 6.4e-8, points within 1.7e-5).

Tolerances and why: the compactions, the outlier mask, the observation
table and `apply_edge_outliers` are integer work: exact. Edge terms are
per-edge f32 arithmetic: 1e-5 relative. One solver step and the whole
two-phase LM run sum their normal equations in f32 through LAPACK
factorizations that round differently from XLA's: poses within 5e-5 and
points within 5e-4 (the ceilings tests/test_parallel.py:160-166 holds the
sharded solve to), and the outlier mask equal. The scatter-adds must add
each row's entries in their order on the CPU, as JAX's scatter does:
`index_add_` does, `index_put_(accumulate=True)` with several threads does
not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.solvers import local_ba as jba
from orb_slam_tpu_torch.convert import map_state_from_numpy
from orb_slam_tpu_torch.solvers import local_ba as tba
from tests.test_system_vo import run_sequence

KM = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def problem():
    return build_problem()


def build_problem():
    """(JAX map, the port's copy, cam_opt, the points seen at least twice)."""
    sys_, _, _ = run_sequence(n_frames=12)
    m = sys_.map
    np.testing.assert_array_equal(np.asarray(sys_.K), KM)
    rng = np.random.default_rng(11)
    cam_opt = np.asarray(m.kf_valid).copy()
    order = np.asarray(sys_.kf_order)
    for slot in np.argsort(np.where(order >= 0, order, 10**9))[:2]:
        cam_opt[slot] = False
    obs = np.asarray(m.kf_obs)
    n_obs = np.bincount(obs[obs >= 0], minlength=m.pt_valid.shape[0])
    xy = np.array(m.kf_xy)
    hit = (obs >= 0) & (n_obs[obs.clip(0)] >= 3) & (rng.random(obs.shape) < 0.03)
    xy[hit] += 25.0
    m = m._replace(kf_xy=jnp.asarray(xy))
    t = map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()},
                             device="cpu")
    _, _, valid = jba.observation_table(m)
    seen = np.asarray(m.pt_valid) & (np.asarray(valid).sum(1) >= 2)
    return m, t, cam_opt, seen


def test_compactions():
    rng = np.random.default_rng(1)
    for _ in range(3):
        cam = rng.random(40) < 0.3
        for a, b in zip(tba._camera_compaction(torch.from_numpy(cam), 16),
                        jba._camera_compaction(jnp.asarray(cam), 16)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        pt = rng.random(300) < 0.4
        for a, b in zip(tba._point_compaction(torch.from_numpy(pt), 128),
                        jba._point_compaction(jnp.asarray(pt), 128)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_edge_terms(problem):
    m, t, _, seen = problem
    okf, ofeat, _, uv, _, _ = jba._ba_inputs(m, jnp.asarray(seen))
    want = jba._edge_terms(m.kf_pose, m.pt_pos, okf, uv, jnp.asarray(KM))
    got = tba._edge_terms(t.kf_pose, t.pt_pos, torch.from_numpy(np.array(okf)),
                          torch.from_numpy(np.array(uv)), torch.from_numpy(KM))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("Kl", [None, 32])
def test_solve_iteration(problem, Kl):
    m, t, cam_opt, seen = problem
    okf, _, _, uv, inv_s2, edge_on = jba._ba_inputs(m, jnp.asarray(seen))
    chi2, _ = jba._edge_chi2(m.kf_pose, m.pt_pos, okf, uv, jnp.asarray(KM), inv_s2)
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    w = inv_s2 * jnp.where(e <= jba.HUBER_DELTA, 1.0, jba.HUBER_DELTA / e) * edge_on
    jp, jx = jba._solve_iteration(m.kf_pose, m.pt_pos, w, okf, uv, jnp.asarray(KM),
                                  jnp.asarray(cam_opt), jnp.asarray(seen),
                                  jnp.float32(1e-3), Kl=Kl)
    tp, tx = tba._solve_iteration(
        t.kf_pose, t.pt_pos, torch.from_numpy(np.array(w)),
        torch.from_numpy(np.array(okf)), torch.from_numpy(np.array(uv)),
        torch.from_numpy(KM), torch.from_numpy(cam_opt), torch.from_numpy(seen),
        torch.tensor(1e-3), Kl=Kl)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=5e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=5e-4)
    assert np.abs(tp.numpy() - t.kf_pose.numpy()).max() > 1e-5   # a real step


@pytest.mark.parametrize("Kl,Pl", [(None, None), (32, None), (32, 256)])
def test_bundle_adjust(problem, Kl, Pl):
    m, t, cam_opt, seen = problem
    sj, oj, (kj, fj) = jba.bundle_adjust(m, jnp.asarray(KM), jnp.asarray(cam_opt),
                                         jnp.asarray(seen), iters1=5, iters2=10,
                                         max_opt_cams=Kl, max_opt_pts=Pl)
    its = []
    st, ot, (kt, ft) = tba.bundle_adjust(t, torch.from_numpy(KM),
                                         torch.from_numpy(cam_opt), torch.from_numpy(seen),
                                         iters1=5, iters2=10, max_opt_cams=Kl,
                                         max_opt_pts=Pl, iterations=its)
    np.testing.assert_allclose(st.kf_pose.numpy(), np.asarray(sj.kf_pose), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(st.pt_pos.numpy(), np.asarray(sj.pt_pos), rtol=0,
                               atol=5e-4)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert len(its) == 1 and 1 <= its[0][0] <= 5 and 0 <= its[0][1] <= 10
    assert ot.sum() > 0


@pytest.mark.parametrize("Kl,Pl", [(None, None), (32, None), (32, 256)])
def test_bundle_adjust_singly_seen(problem, Kl, Pl):
    m, t, cam_opt, seen = problem
    live = np.asarray(m.pt_valid)
    assert (live & ~seen).sum() > 0                 # points seen once
    sj, oj, _ = jba.bundle_adjust(m, jnp.asarray(KM), jnp.asarray(cam_opt),
                                  m.pt_valid, iters1=5, iters2=10,
                                  max_opt_cams=Kl, max_opt_pts=Pl)
    st, ot, _ = tba.bundle_adjust(t, torch.from_numpy(KM), torch.from_numpy(cam_opt),
                                  t.pt_valid, iters1=5, iters2=10, max_opt_cams=Kl,
                                  max_opt_pts=Pl)
    np.testing.assert_allclose(st.kf_pose.numpy(), np.asarray(sj.kf_pose), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(st.pt_pos.numpy(), np.asarray(sj.pt_pos), rtol=0,
                               atol=5e-4)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


@pytest.mark.parametrize("shape", [(6, 6), (6,)])
def test_scatter_add_in_order(shape):
    rng = np.random.default_rng(5)
    n, rows = 20000, 12
    index = torch.from_numpy(rng.integers(0, rows, n))
    values = torch.from_numpy(rng.standard_normal((n,) + shape).astype(np.float32))
    live = torch.from_numpy(rng.random(n) < 0.9)
    got = tba._scatter_add_(torch.zeros((rows + n,) + shape), rows, index, values,
                            live)
    want = np.zeros((rows,) + shape, np.float32)
    for i in np.flatnonzero(live.numpy()):
        want[index[i]] += values[i].numpy()
    np.testing.assert_array_equal(got[:rows].numpy(), want)
    np.testing.assert_array_equal(got[rows:].numpy()[~live.numpy()],
                                  values.numpy()[~live.numpy()])


@pytest.mark.parametrize("kill_starved", [True, False])
def test_apply_edge_outliers(problem, kill_starved):
    m, t, cam_opt, _ = problem
    _, oj, (kj, fj) = jba.bundle_adjust(m, jnp.asarray(KM), jnp.asarray(cam_opt),
                                        m.pt_valid, iters1=2, iters2=2)
    want = jba.apply_edge_outliers(m, oj, kj, fj, kill_starved=kill_starved)
    got = tba.apply_edge_outliers(t, torch.from_numpy(np.array(oj)),
                                  torch.from_numpy(np.array(kj)),
                                  torch.from_numpy(np.array(fj)),
                                  kill_starved=kill_starved)
    np.testing.assert_array_equal(got.kf_obs.numpy(), np.asarray(want.kf_obs))
    np.testing.assert_array_equal(got.pt_valid.numpy(), np.asarray(want.pt_valid))
    assert (got.kf_obs.numpy() != t.kf_obs.numpy()).any()


def test_mesh_is_refused(problem):
    _, t, cam_opt, _ = problem
    with pytest.raises(NotImplementedError):
        tba.bundle_adjust(t, torch.from_numpy(KM), torch.from_numpy(cam_opt),
                          t.pt_valid, mesh=object())
