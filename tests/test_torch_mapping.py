"""Triangulation, new-point insertion, fuse and the culling statistics
against the JAX package, on a small map built with numpy from the
synthetic scene's oracle features (SyntheticScene.observe).

The map: 4 keyframes of 128 features along a lateral path; most features
whose scene point is seen by keyframe 0 are bound to a point slot (the
scene point's id); a few scene points have a second slot that keyframe 2
binds instead, so fuse finds duplicates to merge; the other features are
unbound, so triangulation has candidates.

Tolerances and why: `triangulate_dlt` is a 4x4 eigen-decomposition that
LAPACK and XLA take by different routes: each point within 1e-4 of its
norm on well-conditioned rows; `triangulate_new_points`'s match and gates
are compared exactly (`valid`, `feat_b`), its positions likewise at 1e-4;
`insert_new_points`, `fuse_into_keyframe`, `point_cull_stats` and
`keyframe_redundancy` are integer bookkeeping: exact, including the
last-writer-wins scatters of mapping_kernels.py:193-197 and :287-288.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.geometry import triangulation as jtri
from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.pipeline import mapping_kernels as jmk
from orb_slam_tpu.slam_map.map_state import MapConfig, empty_map
from orb_slam_tpu_torch.convert import map_state_from_numpy
from orb_slam_tpu_torch.geometry import triangulation as ttri
from orb_slam_tpu_torch.pipeline import mapping_kernels as tmk

K, N, P = 6, 128, 512
DUP = 400   # second slots of duplicated scene points start here


def to_port(m):
    return map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()},
                                device="cpu")


def assert_maps_equal(got, want_jax):
    want = to_port(want_jax)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      getattr(want, f.name).numpy(), err_msg=f.name)


@pytest.fixture(scope="module")
def world():
    scene = SyntheticScene(n_points=300, seed=1)
    poses = lateral_trajectory(4, step=0.3)
    rng = np.random.default_rng(5)
    m = empty_map(MapConfig(max_keyframes=K, max_points=P, n_features=N))
    obs = np.full((K, N), -1, np.int32)
    xy = np.zeros((K, N, 2), np.float32)
    octv = np.zeros((K, N), np.int32)
    desc = np.zeros((K, N, 8), np.uint32)
    fvalid = np.zeros((K, N), bool)
    seen0 = set()
    for k, T in enumerate(poses):
        o = scene.observe(T, n_slots=N)
        xy[k], octv[k], desc[k], fvalid[k] = o["xy"], o["octave"], o["desc"], o["valid"]
        ids = o["ids"]
        if k == 0:
            seen0 = set(int(i) for i in ids[ids >= 0])
        for f, i in enumerate(ids):
            if i < 0 or i not in seen0 or rng.random() < 0.3:
                continue
            obs[k, f] = DUP + i % 100 if (k == 2 and i % 5 == 0) else i
    pid = np.arange(P)
    sid = np.where(pid >= DUP, pid - DUP, pid) % scene.n_points
    pt_valid = np.isin(pid, obs[obs >= 0])
    pos = (scene.points[sid] + rng.normal(0, 0.01, (P, 3))).astype(np.float32)
    dist = np.linalg.norm(pos, axis=1)
    kf_pose = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf_pose[:4] = poses
    m = m._replace(
        kf_pose=jnp.asarray(kf_pose), kf_valid=jnp.asarray(np.arange(K) < 4),
        kf_frame_id=jnp.arange(K, dtype=jnp.int32), kf_xy=jnp.asarray(xy),
        kf_octave=jnp.asarray(octv), kf_desc=jnp.asarray(desc),
        kf_feat_valid=jnp.asarray(fvalid), kf_obs=jnp.asarray(obs),
        pt_pos=jnp.asarray(pos), pt_valid=jnp.asarray(pt_valid),
        pt_desc=jnp.asarray(scene.descriptors[sid]),
        pt_normal=jnp.asarray(pos / dist[:, None]),
        pt_min_dist=jnp.asarray((dist / 4).astype(np.float32)),
        pt_max_dist=jnp.asarray((dist * 1.44).astype(np.float32)),
        pt_ref_kf=jnp.zeros(P, jnp.int32),
        pt_first_kf=jnp.asarray(rng.integers(0, 4, P).astype(np.int32)),
        pt_visible=jnp.asarray(rng.integers(1, 9, P).astype(np.int32)),
        pt_found=jnp.asarray(rng.integers(0, 5, P).astype(np.int32)))
    return scene, m, to_port(m)


def row_rel(a, b):
    """|a - b| / |b| per row of points."""
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


def test_triangulate_dlt():
    rng = np.random.default_rng(0)
    n = 200
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 8, n)], 1)
    P1 = np.tile(np.eye(4)[:3], (n, 1, 1)).astype(np.float32)
    P2 = P1.copy()
    P2[:, 0, 3] = -0.5
    x1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    x2 = ((X[:, :2] + [[-0.5, 0.0]]) / X[:, 2:]).astype(np.float32)
    want = np.asarray(jtri.triangulate_dlt(*(jnp.asarray(a) for a in (x1, x2, P1, P2))))
    got = ttri.triangulate_dlt(*(torch.from_numpy(a) for a in (x1, x2, P1, P2))).numpy()
    assert row_rel(got, want).max() < 1e-4
    assert row_rel(got, X).max() < 1e-3
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.2, 0.3]
    Xf = X.astype(np.float32)
    np.testing.assert_allclose(
        ttri.depth_in_frame(torch.from_numpy(T), torch.from_numpy(Xf)).numpy(),
        np.asarray(jtri.depth_in_frame(jnp.asarray(T), jnp.asarray(Xf))), rtol=1e-6)
    C1, C2 = np.zeros(3, np.float32), np.float32([0.5, 0, 0])
    np.testing.assert_allclose(
        ttri.parallax_cos(torch.from_numpy(C1), torch.from_numpy(C2),
                          torch.from_numpy(Xf)).numpy(),
        np.asarray(jtri.parallax_cos(jnp.asarray(C1), jnp.asarray(C2), jnp.asarray(Xf))),
        rtol=1e-6)


@pytest.mark.parametrize("pair", [(0, 1), (3, 1)])
def test_triangulate_new_points(world, pair):
    scene, m, t = world
    a, b = pair
    Kj = jnp.asarray(scene.K)
    want = jmk.triangulate_new_points(m, a, b, Kj)
    got = tmk.triangulate_new_points(t, a, b, torch.from_numpy(scene.K))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.feat_b.numpy(), np.asarray(want.feat_b))
    np.testing.assert_array_equal(got.feat_a.numpy(), np.asarray(want.feat_a))
    assert row_rel(got.pos.numpy()[valid], np.asarray(want.pos)[valid]).max() < 1e-4
    assert valid.sum() >= 5


def port_cand(c):
    return tmk.TriangulationCandidates(*(torch.from_numpy(np.array(v)) for v in c))


def test_insert_new_points(world):
    scene, m, t = world
    cand = jmk.triangulate_new_points(m, 0, 1, jnp.asarray(scene.K))
    free = np.full(512, -1, np.int32)
    slots = np.where(~np.asarray(m.pt_valid))[0][:7]
    free[:len(slots)] = slots
    mj, nj = jmk.insert_new_points(m, 0, 1, cand, jnp.asarray(free))
    mt, nt = tmk.insert_new_points(t, 0, 1, port_cand(cand), torch.from_numpy(free))
    assert int(nt) == int(nj) == min(7, int(np.asarray(cand.valid).sum()))
    assert_maps_equal(mt, mj)


def test_insert_new_points_best_idx_collision(world):
    """An active row binds feature 5 of kf_b; a later inactive row with the
    same best_idx writes the old value back: JAX's last write wins."""
    scene, m, t = world
    rng = np.random.default_rng(2)
    valid = rng.random(N) < 0.2
    feat_b = rng.integers(0, N, N).astype(np.int32)
    valid[3], feat_b[3] = True, 5
    valid[90], feat_b[90] = False, 5
    pos = rng.normal(0, 1, (N, 3)).astype(np.float32)
    cand = jmk.TriangulationCandidates(jnp.asarray(pos), jnp.arange(N, dtype=jnp.int32),
                                       jnp.asarray(feat_b), jnp.asarray(valid))
    free = np.full(64, -1, np.int32)
    free[:40] = np.where(~np.asarray(m.pt_valid))[0][:40]
    mj, nj = jmk.insert_new_points(m, 1, 3, cand, jnp.asarray(free))
    mt, nt = tmk.insert_new_points(t, 1, 3, port_cand(cand), torch.from_numpy(free))
    assert int(nt) == int(nj)
    assert_maps_equal(mt, mj)
    # the hazard is live: row 3's binding of feature 5 was undone
    assert mt.kf_obs[3, 5] == t.kf_obs[3, 5] and mt.kf_obs[1, 3] >= 0


@pytest.mark.parametrize("pair", [(0, 2), (2, 0), (1, 3)])
def test_fuse_into_keyframe(world, pair):
    scene, m, t = world
    src, dst = pair
    kw = dict(width=scene.width, height=scene.height, scale_factor=1.2, n_levels=8)
    mj, bj, gj, rj = jmk.fuse_into_keyframe(m, src, dst, jnp.asarray(scene.K), **kw)
    mt, bt, gt, rt = tmk.fuse_into_keyframe(t, src, dst, torch.from_numpy(scene.K), **kw)
    assert (int(bt), int(gt)) == (int(bj), int(gj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert_maps_equal(mt, mj)
    if 2 in pair:
        assert int(gj) > 0     # duplicates merged


def test_fuse_bind_collision():
    """An unmatched row whose best_idx (0) collides with a matched row that
    binds feature 0 undoes that binding, in JAX and in the port."""
    scene = SyntheticScene(n_points=200, seed=4)
    T = lateral_trajectory(2, step=0.05)
    o0, o1 = scene.observe(T[0], n_slots=64), scene.observe(T[1], n_slots=64)
    # make feature 0 of kf 1 the one row 0 of kf 0 matches
    o1["xy"][0], o1["desc"][0] = o0["xy"][0], o0["desc"][0]
    o1["valid"][0] = True
    m = empty_map(MapConfig(max_keyframes=2, max_points=64, n_features=64))
    obs0 = np.full(64, -1, np.int32)
    obs0[:5] = np.arange(5)
    pos = np.zeros((64, 3), np.float32)
    z = 6.0
    pos[:5] = np.concatenate([(o0["xy"][:5] - [320, 240]) / 500 * z,
                              np.full((5, 1), z)], 1)
    m = m._replace(
        kf_pose=jnp.asarray(np.stack([np.eye(4, dtype=np.float32)] * 2)),
        kf_valid=jnp.ones(2, bool),
        kf_xy=jnp.asarray(np.stack([o0["xy"], o1["xy"]])),
        kf_octave=jnp.zeros((2, 64), jnp.int32),
        kf_desc=jnp.asarray(np.stack([o0["desc"], o1["desc"]])),
        kf_feat_valid=jnp.asarray(np.stack([o0["valid"], o1["valid"]])),
        kf_obs=jnp.asarray(np.stack([obs0, np.full(64, -1, np.int32)])),
        pt_pos=jnp.asarray(pos), pt_valid=jnp.asarray(np.arange(64) < 5),
        pt_desc=jnp.asarray(np.concatenate([o0["desc"][:5],
                                            np.zeros((59, 8), np.uint32)])),
        pt_min_dist=jnp.full(64, 0.1),
        pt_max_dist=jnp.asarray(np.linalg.norm(pos, axis=1) + 1e-3))
    t = to_port(m)
    Kj = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    mj, bj, _, _ = jmk.fuse_into_keyframe(m, 0, 1, jnp.asarray(Kj))
    mt, bt, _, _ = tmk.fuse_into_keyframe(t, 0, 1, torch.from_numpy(Kj))
    assert int(bt) == int(bj) >= 1
    assert_maps_equal(mt, mj)
    assert int(mt.kf_obs[1, 0]) == -1      # row 0's binding was undone


def test_point_cull_stats_and_redundancy(world):
    _, m, t = world
    for a, b in zip(tmk.point_cull_stats(t, 7), jmk.point_cull_stats(m, 7)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for kf in range(4):
        rt, nt = tmk.keyframe_redundancy(t, kf)
        rj, nj = jmk.keyframe_redundancy(m, kf)
        assert float(rt) == float(rj) and int(nt) == int(nj)
