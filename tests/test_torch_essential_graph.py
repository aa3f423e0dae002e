"""The port's essential-graph optimization against the JAX package's, on
the CPU, from the same numpy inputs.

Cases: tests/test_loop_solvers.py:102-199's drift problem (a 12-keyframe
chain whose drift a true loop edge pins), solved dense and by PCG; a
random graph with fixed vertices, invalid (padded) edges and empty
keyframe slots held fixed, as the loop closer builds it; and
relative_sim3_batch. Tolerances and why: s, R and t within 1e-4 (the
normal equations are summed in another order and solved by another
LAPACK call; 15 LM steps on f32 move the optimum by a few ulps of the
step each), relative_sim3_batch within 1e-5 (a few f32 products of
magnitude up to 10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from orb_slam_tpu.solvers import essential_graph as JE
from orb_slam_tpu_torch.solvers import essential_graph as TE

T = torch.from_numpy


def near(a, b, tol):
    np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                               atol=tol, rtol=0)


def drift_problem():
    K = 12
    true_s = np.ones(K, np.float32)
    true_R = np.stack([np.eye(3, dtype=np.float32)] * K)
    true_t = np.stack([np.array([0.5 * k, 0, 0], np.float32) for k in range(K)])
    est_s, est_t = np.ones(K, np.float32), true_t.copy()
    drift = np.zeros(3, np.float32)
    for k in range(1, K):
        drift += np.array([0.02, 0.01, 0.0], np.float32)
        est_t[k] = true_t[k] + drift
        est_s[k] = 1.0 + 0.01 * k
    pairs = [(k, k + 1) for k in range(K - 1)] + [(0, K - 1)]
    ei = np.array([a for a, _ in pairs], np.int32)
    ej = np.array([b for _, b in pairs], np.int32)
    ms, mR, mt = (np.asarray(x) for x in JE.relative_sim3_batch(
        *(jnp.asarray(x) for x in (true_s[ei], true_R[ei], true_t[ei],
                                   true_s[ej], true_R[ej], true_t[ej]))))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (est_s, true_R, est_t, ei, ej, ms, mR, mt, np.ones(len(ei), bool), fixed)


def random_graph(seed=0, K=24, n_live=18, E_pad=64):
    """Live keyframes 0..n_live-1 (the rest empty slots, fixed), a chain
    plus random extra edges among them with noisy measurements, the
    padding edges invalid, keyframe 3 fixed (the loop keyframe)."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.8, 1.25, K).astype(np.float32)
    R = ScipyRot.from_rotvec(rng.normal(0, 0.4, (K, 3))).as_matrix().astype(np.float32)
    t = rng.normal(0, 2.0, (K, 3)).astype(np.float32)
    pairs = {(k, k + 1) for k in range(n_live - 1)}
    while len(pairs) < 40:
        a, b = sorted(rng.choice(n_live, 2, replace=False).tolist())
        pairs.add((a, b))
    pairs = sorted(pairs)
    n_e = len(pairs)
    ei = np.zeros(E_pad, np.int32)
    ej = np.zeros(E_pad, np.int32)
    ev = np.zeros(E_pad, bool)
    ei[:n_e] = [a for a, _ in pairs]
    ej[:n_e] = [b for _, b in pairs]
    ev[:n_e] = True
    noise = ScipyRot.from_rotvec(rng.normal(0, 0.05, (E_pad, 3))).as_matrix().astype(np.float32)
    ms, mR, mt = (np.asarray(x) for x in JE.relative_sim3_batch(
        *(jnp.asarray(x) for x in (s[ei], R[ei], t[ei], s[ej], R[ej], t[ej]))))
    mR = (noise @ mR).astype(np.float32)
    mt = (mt + rng.normal(0, 0.1, mt.shape)).astype(np.float32)
    ms = (ms * rng.uniform(0.95, 1.05, E_pad)).astype(np.float32)
    fixed = np.arange(K) >= n_live
    fixed[3] = True
    return (s, R, t, ei, ej, ms, mR, mt, ev, fixed)


def both(args, **kw):
    a = JE.optimize_essential_graph(*(jnp.asarray(x) for x in args), **kw)
    b = TE.optimize_essential_graph(*(T(np.array(x)) for x in args), **kw)
    return [np.asarray(x) for x in a], [y.numpy() for y in b]


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_drift_problem_matches_jax(solver):
    args = drift_problem()
    a, b = both(args, iters=15, solver=solver, cg_iters=60)
    for x, y in zip(a, b):
        near(x, y, 1e-4)
    # the fixed vertex is untouched, and the drift is spread
    near(args[2][0], b[2][0], 1e-6)
    assert np.abs(b[2] - np.stack([[0.5 * k, 0, 0] for k in range(12)])).max() < 0.02


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_graph_with_fixed_and_padding_matches_jax(seed, solver):
    args = random_graph(seed)
    a, b = both(args, iters=15, solver=solver)
    for x, y in zip(a, b):
        near(x, y, 1e-4)
    fixed = args[-1]
    near(args[0][fixed], b[0][fixed], 1e-6)
    near(args[2][fixed], b[2][fixed], 1e-5)


def test_relative_sim3_batch_matches_jax():
    args = random_graph(2)
    s, R, t, ei, ej = args[:5]
    a = JE.relative_sim3_batch(*(jnp.asarray(x) for x in (s[ei], R[ei], t[ei],
                                                          s[ej], R[ej], t[ej])))
    b = TE.relative_sim3_batch(*(T(np.ascontiguousarray(x)) for x in (
        s[ei], R[ei], t[ei], s[ej], R[ej], t[ej])))
    for x, y in zip(a, b):
        near(np.asarray(x), y.numpy(), 1e-5)
    c = JE.relative_sim3(*(jnp.asarray(x) for x in (s[0], R[0], t[0], s[1], R[1], t[1])))
    d = TE.relative_sim3(*(torch.tensor(x) for x in (s[0], R[0], t[0], s[1], R[1], t[1])))
    for x, y in zip(c, d):
        near(np.asarray(x), y.numpy(), 1e-5)
