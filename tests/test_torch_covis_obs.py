"""Covisibility, the observation table and the point statistics against the
JAX package, on a small random map made with numpy from a seed.

Tolerances and why: every integer output (the incidence matrix, weights,
counts, local-map mask, top-k, essential edges, the observation table,
the distinctive descriptors, the reference keyframes) is exact; normals
and distance bands come from f32 norms and powers that may round in
another order: within 1e-5. The table's cap is 2 here, so points with
more observations overflow it, and point P-1 is observed by several
keyframes: JAX's scatter leaves its row empty, and so must the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.slam_map import covisibility as jc
from orb_slam_tpu.slam_map import map_state as jms
from orb_slam_tpu.slam_map import observations as jo
from orb_slam_tpu_torch.convert import map_state_from_numpy
from orb_slam_tpu_torch.slam_map import covisibility as tc
from orb_slam_tpu_torch.slam_map import map_state as tms
from orb_slam_tpu_torch.slam_map import observations as to

K, P, N = 8, 64, 32


def random_pose(rng):
    a = rng.normal(0, 0.1, 3)
    th = np.linalg.norm(a)
    k = a / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(0, 0.5, 3)
    return T


def random_map(seed, kf_valid_frac=0.8, pt_valid_frac=0.9):
    """A JAX MapState: each keyframe binds a random subset of the points,
    each point at most once, point P-1 in at least three keyframes."""
    rng = np.random.default_rng(seed)
    m = jms.empty_map(jms.MapConfig(max_keyframes=K, max_points=P, n_features=N))
    obs = np.full((K, N), -1, np.int32)
    for k in range(K):
        pids = rng.choice(P - 1, size=rng.integers(N // 2, N), replace=False)
        if k < 3:
            pids[0] = P - 1
        feats = rng.choice(N, size=len(pids), replace=False)
        obs[k, feats] = pids
    kf_valid = rng.random(K) < kf_valid_frac
    kf_valid[:3] = True
    pt_valid = rng.random(P) < pt_valid_frac
    pt_valid[P - 1] = True
    pos = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P),
                    rng.uniform(4, 9, P)], 1).astype(np.float32)
    return m._replace(
        kf_pose=jnp.asarray(np.stack([random_pose(rng) for _ in range(K)])),
        kf_valid=jnp.asarray(kf_valid),
        kf_xy=jnp.asarray(rng.uniform(0, 640, (K, N, 2)).astype(np.float32)),
        kf_octave=jnp.asarray(rng.integers(0, 8, (K, N)).astype(np.int32)),
        kf_desc=jnp.asarray(rng.integers(0, 2 ** 32, (K, N, 8), dtype=np.uint32)),
        kf_feat_valid=jnp.ones((K, N), bool),
        kf_obs=jnp.asarray(obs),
        pt_pos=jnp.asarray(pos),
        pt_valid=jnp.asarray(pt_valid),
        pt_ref_kf=jnp.asarray(rng.integers(-1, K, P).astype(np.int32)),
        spanning_parent=jnp.asarray(np.array([-1] + list(range(K - 1)), np.int32)),
        loop_edges=jnp.asarray(np.where(rng.random((K, 8)) < 0.2,
                                        rng.integers(0, K, (K, 8)), -1).astype(np.int32)),
    )


def to_port(m):
    return map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()},
                                device="cpu")


@pytest.fixture(params=[0, 1], scope="module")
def maps(request):
    m = random_map(request.param)
    return m, to_port(m)


def test_incidence_weights_counts(maps):
    m, t = maps
    np.testing.assert_array_equal(tc.incidence_matrix(t).numpy(),
                                  np.asarray(jc.incidence_matrix(m)))
    W = tc.covisibility_weights(t)
    np.testing.assert_array_equal(W.numpy(), np.asarray(jc.covisibility_weights(m)))
    assert W.dtype == torch.int32 and int(W.max()) > 0
    np.testing.assert_array_equal(tc.observation_counts(t).numpy(),
                                  np.asarray(jc.observation_counts(m)))


@pytest.mark.parametrize("ref", [0, 2, 5])
def test_local_point_mask(maps, ref):
    m, t = maps
    got = tc.local_point_mask(t, ref).numpy()
    np.testing.assert_array_equal(got, np.asarray(jc.local_point_mask(m, jnp.int32(ref))))
    assert got.any()


def test_best_covisible_and_essential_edges(maps):
    m, t = maps
    Wj = jc.covisibility_weights(m)
    Wt = tc.covisibility_weights(t)
    for slot in range(K):
        sj, wj = jc.best_covisible(Wj, slot, 5)
        st, wt = tc.best_covisible(Wt, slot, 5)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    for th in (1, 5, 100):
        np.testing.assert_array_equal(
            tc.essential_edges(Wt, t.spanning_parent, t.loop_edges, th).numpy(),
            np.asarray(jc.essential_edges(Wj, m.spanning_parent, m.loop_edges, th)))


def test_flatten_observations(maps):
    m, t = maps
    for a, b in zip(to.flatten_observations(t), jo.flatten_observations(m)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cap", [2, 16])
def test_observation_table_last_slot(maps, cap):
    """Exact, including the emptied row P-1 though point P-1 is live."""
    m, t = maps
    got = to.observation_table(t, cap)
    want = jo.observation_table(m, cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n_obs = np.asarray(jc.observation_counts(m))
    assert n_obs[P - 1] >= 2 and not got[2][P - 1].any()
    assert (n_obs > cap).any() == (cap == 2)


def test_refresh_point_stats(maps):
    m, t = maps
    want = jo.refresh_point_stats(m, scale_factor=1.2, n_levels=8)
    got = to.refresh_point_stats(t, scale_factor=1.2, n_levels=8)
    np.testing.assert_array_equal(got.pt_desc.numpy(),
                                  np.asarray(want.pt_desc).view(np.int32))
    np.testing.assert_array_equal(got.pt_ref_kf.numpy(), np.asarray(want.pt_ref_kf))
    np.testing.assert_allclose(got.pt_normal.numpy(), np.asarray(want.pt_normal),
                               rtol=0, atol=1e-5)
    for f in ("pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, err_msg=f)
    assert (got.pt_desc.numpy() != t.pt_desc.numpy()).any()


def test_obs_cap_reads_the_same_variable():
    assert to.OBS_CAP == jo.OBS_CAP


def test_remove_points_and_keyframe(maps):
    m, t = maps
    kill = np.random.default_rng(3).random(P) < 0.3
    want = jms.remove_keyframe(jms.remove_points(m, jnp.asarray(kill)), 2)
    got = tms.remove_keyframe(tms.remove_points(t, torch.from_numpy(kill)), 2)
    ref = to_port(want)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      getattr(ref, f.name).numpy(), err_msg=f.name)
