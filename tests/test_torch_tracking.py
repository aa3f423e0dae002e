"""Tracking against the JAX package: matching, one tracking step, and a
chained chunk fed the same oracle features (SyntheticScene.observe).

Tolerances and why:
- Hamming distances, `match` and `resolve_duplicates` are integer
  computations: exact;
- the projections are f32 sums that may round differently, so the
  frustum gate and the match window may differ on a point lying on a
  boundary: at most 0.5% of visibilities or matches may differ;
- poses come out of f32 Gauss-Newton sums in another order: atol 1e-4
  (tests/test_solvers.py:243), inlier counts within max(2, 1%).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.ops import matching as jm
from orb_slam_tpu.pipeline import track_kernels as jtk
from orb_slam_tpu.slam_map.map_state import MapConfig, add_points, empty_map
from orb_slam_tpu_torch.convert import map_state_from_numpy
from orb_slam_tpu_torch.ops import matching as tm
from orb_slam_tpu_torch.pipeline import track_kernels as ttk

P, NS = 1024, 256


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.uint32).view(np.int32)))


def jax_map(scene, seed=0):
    """A 1024-slot map: the scene's points with their descriptors, plus
    jittered copies with random descriptors (bench.py:69-86)."""
    rng = np.random.default_rng(seed)
    cfg = MapConfig(max_keyframes=8, max_points=P, n_features=NS)
    n_extra = P - 64 - scene.n_points
    extra = scene.points[rng.integers(0, scene.n_points, n_extra)] + rng.normal(
        0, 0.01, (n_extra, 3)).astype(np.float32)
    pos = np.concatenate([scene.points, extra]).astype(np.float32)
    desc = np.concatenate([scene.descriptors, rng.integers(
        0, 2 ** 32, (n_extra, 8), dtype=np.uint32)])
    n = len(pos)
    m = add_points(empty_map(cfg), jnp.arange(n), jnp.asarray(pos),
                   jnp.asarray(desc), jnp.zeros(n, jnp.int32),
                   jnp.zeros(n, jnp.int32), jnp.ones(n, bool))
    # distance band and normal as MapPoint::UpdateNormalAndDepth would set
    # them from the first pose, at the octave observe() gives that depth
    ray = np.concatenate([pos, np.zeros((P - n, 3), np.float32)])
    dist = np.maximum(np.linalg.norm(ray, axis=1), 1e-3)
    z = ray[:, 2]
    octave = np.clip((3 - 3 * (z - 4.0) / 8.0).astype(np.int32), 0, 7)
    max_dist = (dist * 1.2 ** octave).astype(np.float32)
    return m._replace(pt_max_dist=jnp.asarray(max_dist),
                      pt_min_dist=jnp.asarray(max_dist / 1.2 ** 7),
                      pt_normal=jnp.asarray(ray / dist[:, None]))


def to_port(m):
    return map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()},
                                device="cpu")


@pytest.fixture(scope="module")
def world():
    scene = SyntheticScene(n_points=500, seed=3)
    poses = lateral_trajectory(5, step=0.02)
    obs = [scene.observe(p, n_slots=NS) for p in poses]
    m = jax_map(scene)
    return scene, poses, obs, m, to_port(m)


@pytest.mark.parametrize("seed", [0, 1])
def test_hamming_and_match(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    b = a[rng.integers(0, 300, 250)].copy()
    b[:, 0] ^= rng.integers(0, 2 ** 8, 250).astype(np.uint32)   # near copies
    b[::3, 1] ^= np.uint32(0xFFFF)                                 # far ones
    np.testing.assert_array_equal(
        tm.hamming_matrix(i32(a), i32(b)).numpy(),
        np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    allowed = rng.random((300, 250)) > 0.3
    va, vb = rng.random(300) > 0.1, rng.random(250) > 0.1
    for max_dist, ratio in [(100, 0.9), (50, 1.0), (256, 0.9)]:
        ij, dj, mj = jm.match(jnp.asarray(a), jnp.asarray(b), jnp.asarray(allowed),
                              jnp.asarray(va), jnp.asarray(vb), max_dist=max_dist,
                              nn_ratio=ratio, unique=True)
        it, dt, mt = tm.match(i32(a), i32(b), torch.from_numpy(allowed),
                              torch.from_numpy(va), torch.from_numpy(vb),
                              max_dist=max_dist, nn_ratio=ratio, unique=True)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_resolve_duplicates_ties():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 20, 200).astype(np.int32)
    dist = rng.integers(0, 5, 200).astype(np.int32)     # many equal distances
    valid = rng.random(200) > 0.2
    want = jm.resolve_duplicates(jnp.asarray(idx), jnp.asarray(dist),
                                 jnp.asarray(valid), 20)
    got = tm.resolve_duplicates(torch.from_numpy(idx).long(), torch.from_numpy(dist),
                                torch.from_numpy(valid), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_frustum_gate(world):
    scene, poses, _, m, ms = world
    K = scene.K
    vj, pj, lj, dj = jtk.frustum_gate(m, jnp.asarray(poses[2]), jnp.asarray(K), 640, 480)
    vt, pt, lt, dt = ttk.frustum_gate(ms, torch.from_numpy(poses[2]),
                                      torch.from_numpy(K), 640, 480)
    assert np.mean(vt.numpy() != np.asarray(vj)) <= 0.005
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


@pytest.mark.parametrize("p_local", [512, 256])
def test_track_frame(world, p_local):
    """p_local 512 > the 256 compacted rows; 256 runs uncompacted."""
    scene, poses, obs, m, ms = world
    o = obs[1]
    T_pred = poses[0]
    rj = jtk.track_frame(m, jnp.asarray(o["xy"]), jnp.asarray(o["desc"]),
                         jnp.asarray(o["octave"]), jnp.asarray(o["valid"]),
                         jnp.asarray(T_pred), jnp.asarray(scene.K), p_local=p_local)
    rt = ttk.track_frame(ms, torch.from_numpy(o["xy"]), i32(o["desc"]),
                         torch.from_numpy(o["octave"]), torch.from_numpy(o["valid"]),
                         torch.from_numpy(T_pred), torch.from_numpy(scene.K),
                         p_local=p_local)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-4)
    assert abs(int(rt.n_matches) - int(rj.n_matches)) <= max(2, NS // 200)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= max(2, NS // 100)
    assert np.mean(rt.obs.numpy() != np.asarray(rj.obs)) <= 0.01
    assert np.mean(rt.visible_inc.numpy() != np.asarray(rj.visible_inc)) <= 0.005
    assert np.sum(rt.found_inc.numpy() != np.asarray(rj.found_inc)) <= max(2, NS // 100)
    assert int(rt.n_inliers) >= 100


def test_track_chunk(world):
    scene, poses, obs, m, ms = world
    stack = lambda k: np.stack([o[k] for o in obs[1:]])
    rj = jtk.track_chunk(m, jnp.asarray(stack("xy")), jnp.asarray(stack("desc")),
                         jnp.asarray(stack("octave")), jnp.asarray(stack("valid")),
                         jnp.asarray(poses[0]), jnp.eye(4), jnp.asarray(scene.K),
                         p_local=512)
    rt = ttk.track_chunk(ms, torch.from_numpy(stack("xy")), i32(stack("desc")),
                         torch.from_numpy(stack("octave")),
                         torch.from_numpy(stack("valid")), torch.from_numpy(poses[0]),
                         torch.eye(4), torch.from_numpy(scene.K), p_local=512)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-4)
    np.testing.assert_allclose(rt.pose.numpy(), poses[1:], atol=5e-3)
    dn = np.abs(rt.n_inliers.numpy() - np.asarray(rj.n_inliers))
    assert dn.max() <= max(2, NS // 100)
    dm = np.abs(rt.n_matches.numpy() - np.asarray(rj.n_matches))
    assert dm.max() <= max(2, NS // 200)
    assert np.mean(rt.obs.numpy() != np.asarray(rj.obs)) <= 0.01
    assert np.mean(rt.visible.numpy() != np.asarray(rj.visible)) <= 0.005


def test_map_updates_match_jax():
    """empty_map, add_points with inactive rows, insert_keyframe: every
    field equal to the JAX package's after conversion."""
    from orb_slam_tpu.slam_map.map_state import insert_keyframe as j_insert
    from orb_slam_tpu_torch.slam_map import map_state as tms

    rng = np.random.default_rng(9)
    cfg = MapConfig(max_keyframes=4, max_points=64, n_features=16)
    slots = rng.permutation(64)[:20].astype(np.int32)
    pos = rng.normal(size=(20, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (20, 8), dtype=np.uint32)
    ref, first = rng.integers(0, 4, 20).astype(np.int32), rng.integers(0, 4, 20).astype(np.int32)
    active = rng.random(20) > 0.3
    kf = dict(pose=rng.normal(size=(4, 4)).astype(np.float32), frame_id=7,
              xy=rng.normal(size=(16, 2)).astype(np.float32),
              octave=rng.integers(0, 8, 16).astype(np.int32),
              angle=rng.normal(size=16).astype(np.float32),
              desc=rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint32),
              feat_valid=rng.random(16) > 0.5,
              obs=rng.integers(-1, 64, 16).astype(np.int32), parent=1)
    m = add_points(empty_map(cfg), jnp.asarray(slots), jnp.asarray(pos), jnp.asarray(desc),
                   jnp.asarray(ref), jnp.asarray(first), jnp.asarray(active))
    m = j_insert(m, 2, *(jnp.asarray(v) for v in kf.values()))
    t = tms.add_points(tms.empty_map(tms.MapConfig(max_keyframes=4, max_points=64,
                                                    n_features=16), device="cpu"),
                       torch.from_numpy(slots), torch.from_numpy(pos), i32(desc),
                       torch.from_numpy(ref), torch.from_numpy(first),
                       torch.from_numpy(active))
    kf_t = {k: (i32(v) if k == "desc" else torch.as_tensor(v)) for k, v in kf.items()}
    t = tms.insert_keyframe(t, 2, *kf_t.values())
    want = to_port(m)
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(getattr(t, f.name).numpy(),
                                      getattr(want, f.name).numpy(), err_msg=f.name)
