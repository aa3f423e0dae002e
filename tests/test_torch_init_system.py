"""The port's initialisation and tracking ladder against the JAX package's
SLAMSystem, on the CPU, from the same oracle features, plus the matching
pieces they use.

`_try_initialize`: tests/test_system_vo.py's scene and configuration
(oracle features, 200 slots, loop closing and relocalisation off) fed
frame by frame to a JAX system and to the port's; before each
initialisation attempt the test draws the sets JAX will draw
(`jax.random.split` of the system's key, then `_sample_minimal_sets` on
JAX's own match mask) and hands them to the port through the
`_minimal_sets` hook. Tolerances and why: the host lists (free points,
keyframe order, the trajectory's frame ids) equal, and the bindings,
descriptors and validity of the map equal. The two-view global BA fixes
only the first keyframe, so the map's scale is a free direction of its
normal equations (a gauge) and its damping is absolute (1e-3): f32
rounding in the gradient along that direction moves the scale by a whole
LM step. Measured on this scene (8-core Intel Xeon CPU): the port's
map ends 3.79x JAX's at the suite's SLAM_OBS_CAP=16, 1.04x at 32, and
1.03x when the port's BA starts from JAX's own pre-BA map, in 3 + 1 LM
iterations. So the map is compared after one scale, the ratio of the
second keyframe's translations (held within 0.1-10, finite and
positive): then poses within 1e-4 and points within 1.5e-2, the bound
of points seen by two keyframes (ROADMAP C7,
tests/test_torch_system_map.py). Measured after the scale: poses
2.1e-6, points 1.7e-4 (median 3.3e-5), no validity flip. The two-view
step before the BA agrees in R within 2.7e-6 and in the unit t within
3.7e-4: the F refit is an f32 eigensolve of a Gram matrix whose
conditioning squares that of the small-parallax pair (JAX's t is 1.6e-4
from a float64 solve, the port's 5.2e-4).

`track_prev_frame`: the state of tests/test_prev_frame.py's
`build_tracking_system` (8 frames here) carried over by convert.py, the
next frame matched by both, from stage 1 (coarse octave 0) and through
stage 2 (coarse octave 4, which oracle features at octave 0 leave
empty): pose within 1e-4, inlier and match counts within max(2, 1%).

`_track`'s LOST: a frame of random features loses both systems; with at
most 5 keyframes both reset (Tracking.cc:272-279), otherwise the port
counts `lost_count` and, with a keyframe database of its keyframes,
reaches `_relocalize`, which finds no match to draw EPnP sets from and
leaves the camera LOST.

Matching: `window_gate`, `rotation_consistency_mask` on histograms with
many tied bins and `match(mutual, check_rotation)` are integer or exact
float computations: equal.
"""

import copy
from dataclasses import replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.ops import matching as jm
from orb_slam_tpu.pipeline import system as jsys_mod
from orb_slam_tpu.pipeline.track_kernels import track_prev_frame as jax_prev
from orb_slam_tpu.solvers.two_view import _sample_minimal_sets
from orb_slam_tpu_torch.convert import map_state_from_numpy
from orb_slam_tpu_torch.io.synthetic import SyntheticScene as TorchScene
from orb_slam_tpu_torch.ops import matching as tm
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.pipeline.track_kernels import track_prev_frame
from orb_slam_tpu_torch.place import KeyFrameDatabase
from orb_slam_tpu_torch.place.pretrained import load_pretrained
from orb_slam_tpu_torch.slam_map.map_state import MapConfig
from tests.test_prev_frame import build_tracking_system
from tests.test_torch_system_map import _two_threads  # noqa: F401 (autouse)


T = torch.from_numpy


def i32(a):
    return T(np.ascontiguousarray(np.asarray(a).astype(np.uint32).view(np.int32)))


def port_config(jc, camera):
    """The port's SlamConfig of a JAX SlamConfig in oracle mode, with the
    port's `camera`."""
    return tsys.SlamConfig(
        camera=camera, orb=None,
        map=MapConfig(max_keyframes=jc.map.max_keyframes,
                      max_points=jc.map.max_points, n_features=jc.map.n_features,
                      n_levels=jc.map.n_levels, scale_factor=jc.map.scale_factor),
        p_local=jc.p_local, n_triangulation_neighbors=jc.n_triangulation_neighbors,
        n_fuse_neighbors=jc.n_fuse_neighbors, local_ba_window=jc.local_ba_window,
        enable_loop_closing=False, enable_relocalisation=False, seed=jc.seed)


def jax_sets_for(js, feats):
    """The sets JAX's next `_try_initialize` of `feats` draws."""
    frame = js.make_frame(features=feats)
    ref = js.init_ref
    gate = jm.window_gate(ref.xy, frame.xy, 100.0)
    _, _, ok = jm.match(ref.desc, frame.desc, allowed=gate, valid_a=ref.valid,
                        valid_b=frame.valid, angle_a=ref.angle, angle_b=frame.angle,
                        max_dist=jm.TH_LOW, nn_ratio=0.9, mutual=True,
                        check_rotation=True, unique=True)
    _, key = jax.random.split(js._rng)
    return np.asarray(_sample_minimal_sets(key, ok, 200, 8))


@pytest.fixture(scope="module")
def initialized():
    """(JAX system, port system, scene, poses, frames fed) once both have
    initialised from the same oracle frames."""
    scene = SyntheticScene(n_points=500, seed=0)
    poses = lateral_trajectory(12, step=0.08)
    jc = jsys_mod.SlamConfig(
        camera=scene.camera_model(),
        map=jsys_mod.MapConfig(max_keyframes=32, max_points=2048, n_features=200),
        p_local=512, n_triangulation_neighbors=3, n_fuse_neighbors=2,
        local_ba_window=6, enable_loop_closing=False, enable_relocalisation=False)
    jc.orb = None
    js = jsys_mod.SLAMSystem(jc)
    ts = tsys.SLAMSystem(
        port_config(jc, TorchScene(n_points=500, seed=0).camera_model()),
        device="cpu")
    for i in range(len(poses)):
        feats = scene.observe(poses[i], n_slots=200)
        if js.state == jsys_mod.INITIALIZING:
            sets = jax_sets_for(js, feats)
            ts._minimal_sets = lambda valid, sets=sets: T(sets.copy())
        out_j = js.process(features=feats)
        out_t = ts.process(features=feats)
        assert (out_j is None) == (out_t is None) and js.state == ts.state
        if js.state == jsys_mod.WORKING:
            return js, ts, scene, poses, i + 1
    raise AssertionError("the JAX system never initialised")


def gauge(js, ts):
    """The scale that takes the port's map onto JAX's: the ratio of the
    second keyframe's translations."""
    tj = np.asarray(js.map.kf_pose[js.last_kf_slot])[:3, 3]
    tt = ts.map.kf_pose[ts.last_kf_slot].numpy()[:3, 3]
    s = float(tj @ tt / (tt @ tt))
    assert 0.1 < s < 10.0
    return s


def scaled(T_cw, s):
    T_cw = np.array(T_cw)
    T_cw[..., :3, 3] *= s
    return T_cw


def test_try_initialize_host_lists(initialized):
    js, ts, _, _, n = initialized
    assert ts.state == tsys.WORKING and n <= 4
    assert ts.free_pt == js.free_pt and ts.free_kf == js.free_kf
    np.testing.assert_array_equal(ts.kf_order, js.kf_order)
    assert [r[0] for r in ts.trajectory] == [r[0] for r in js.trajectory]
    assert (ts.last_kf_slot, ts.last_kf_frame, ts.ref_kf_tracked) == (
        js.last_kf_slot, js.last_kf_frame, js.ref_kf_tracked)
    np.testing.assert_allclose(scaled(ts.last_pose, gauge(js, ts)), js.last_pose,
                               atol=1e-4)
    np.testing.assert_array_equal(ts.local_mask.numpy(), np.asarray(js.local_mask))


def test_try_initialize_map(initialized):
    js, ts, _, _, _ = initialized
    jm_, tm_ = js.map, ts.map
    s = gauge(js, ts)
    np.testing.assert_allclose(scaled(tm_.kf_pose.numpy(), s), np.asarray(jm_.kf_pose),
                               atol=1e-4)
    pv = np.asarray(jm_.pt_valid)
    assert (pv != tm_.pt_valid.numpy()).sum() <= 2
    both = pv & tm_.pt_valid.numpy()
    d = np.abs(s * tm_.pt_pos.numpy() - np.asarray(jm_.pt_pos))[both].max()
    assert d < 1.5e-2
    for f in ("kf_obs", "kf_valid", "kf_frame_id", "spanning_parent", "pt_ref_kf"):
        np.testing.assert_array_equal(getattr(tm_, f).numpy(), np.asarray(getattr(jm_, f)))
    np.testing.assert_array_equal(tm_.kf_desc.numpy(), i32(jm_.kf_desc).numpy())
    np.testing.assert_array_equal(tm_.pt_desc.numpy()[both], i32(jm_.pt_desc).numpy()[both])
    # the map is scaled to unit median depth (Tracking.cc:439-463)
    assert ts.n_points > 100


def test_keyframe_trajectory(initialized):
    js, ts, _, _, _ = initialized
    rows_t, rows_j = ts.keyframe_trajectory(), js.keyframe_trajectory()
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
    s = gauge(js, ts)
    for (_, t1, q1), (_, t2, q2) in zip(rows_t, rows_j):
        np.testing.assert_allclose(s * t1, np.asarray(t2), atol=1e-4)
        np.testing.assert_allclose(q1, np.asarray(q2), atol=1e-4)


def garbage_features(n, seed=5):
    rng = np.random.default_rng(seed)
    return dict(xy=rng.uniform(0, 640, (n, 2)).astype(np.float32),
                desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
                octave=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
                valid=np.ones(n, bool))


def copies(initialized):
    js, ts, *_ = initialized
    a, b = copy.copy(js), copy.copy(ts)
    for s in (a, b):
        s.free_kf, s.free_pt = list(s.free_kf), list(s.free_pt)
        s.kf_order, s.pt_forward = s.kf_order.copy(), s.pt_forward.copy()
        s.trajectory = list(s.trajectory)
    return a, b


def test_lost_soon_after_init_resets(initialized):
    a, b = copies(initialized)
    g = garbage_features(200)
    assert a.process(features=g) is None and b.process(features=g) is None
    assert a.state == b.state == tsys.NO_IMAGES_YET
    assert b.lost_count == a.lost_count == 0 and b.n_keyframes == 0
    assert b.free_pt == list(range(b.cfg.map.max_points)) and b.trajectory == []


def test_lost_counts_and_failed_relocalisation(initialized):
    _, b = copies(initialized)
    b.kf_counter = 6                        # no auto-reset past 5 keyframes
    assert b.process(features=garbage_features(200)) is None
    assert b.state == tsys.LOST and b.lost_count == 1 and b._prev_frame is None
    np.testing.assert_array_equal(b.velocity, np.eye(4, dtype=np.float32))
    assert b.process(features=garbage_features(200, seed=6)) is None
    assert b.lost_count == 2
    # a real keyframe database of the live keyframes: the garbage frame
    # matches no candidate's features, so EPnP is never reached
    b.cfg = dc_replace(b.cfg, enable_relocalisation=True)
    b.db = KeyFrameDatabase(load_pretrained(), b.cfg.map.max_keyframes,
                            b.cfg.bow_slots, device="cpu")
    for slot in np.where(b.map.kf_valid.numpy())[0]:
        b.db.add(slot, *b.db.compute_bow(b.map.kf_desc[slot],
                                         b.map.kf_feat_valid[slot])[:2])
    draws = []
    b._reloc_sets = lambda valid: draws.append(valid)
    assert b.process(features=garbage_features(200, seed=7)) is None
    assert b.state == tsys.LOST and b.lost_count == 3 and b.n_relocs == 0
    assert draws == [] and b.db.active.sum() == b.n_keyframes


@pytest.fixture(scope="module")
def prev_state():
    scene, poses, s, i = build_tracking_system(n_frames=8)
    cur = s.make_frame(features=scene.observe(poses[i], n_slots=256))
    return s, cur


@pytest.mark.parametrize("coarse", [0, 4])
def test_track_prev_frame(prev_state, coarse):
    s, cur = prev_state
    cfg = s.cfg
    pf, pobs = s._prev_frame
    kw = dict(width=cfg.camera.width, height=cfg.camera.height,
              scale_factor=cfg.map.scale_factor, n_levels=cfg.map.n_levels)
    jT, jn, jm_n = jax_prev(s.map, pf.xy, pf.desc, pf.octave, pf.angle, pobs,
                            cur.xy, cur.desc, cur.octave, cur.angle, cur.valid,
                            jnp.asarray(s.last_pose), s.K_dev, jnp.int32(coarse), **kw)
    m = map_state_from_numpy({k: np.asarray(v) for k, v in s.map._asdict().items()},
                             device="cpu")
    f = lambda v: T(np.array(v))
    tT, tn, tm_n = track_prev_frame(
        m, f(pf.xy), i32(pf.desc), f(pf.octave), f(pf.angle), f(pobs),
        f(cur.xy), i32(cur.desc), f(cur.octave), f(cur.angle), f(cur.valid),
        f(s.last_pose), f(s.K_dev), coarse, **kw)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    assert abs(int(tn) - int(jn)) <= max(2, int(0.01 * int(jn)))
    assert abs(int(tm_n) - int(jm_n)) <= max(2, int(0.01 * int(jm_n)))
    assert int(tm_n) > 50 and int(tn) > 30


def tie_heavy(rng, n=400):
    """Angles whose differences fill few bins, many of them with equal
    counts."""
    a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    bins = rng.choice([3, 7, 11, 12, 20, 29], n)
    b = (a - bins * (2 * np.pi / 30)).astype(np.float32)
    return a, b, rng.random(n) < 0.8


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rotation_consistency_mask(seed):
    rng = np.random.default_rng(seed)
    a, b, valid = tie_heavy(rng)
    if seed == 3:                       # three exactly tied bins
        a = np.zeros(30, np.float32)
        b = -np.repeat(np.array([5, 9, 17], np.float32), 10) * (2 * np.pi / 30)
        b = b.astype(np.float32)
        valid = np.ones(30, bool)
    j = np.asarray(jm.rotation_consistency_mask(jnp.asarray(a), jnp.asarray(b),
                                                jnp.asarray(valid)))
    t = tm.rotation_consistency_mask(T(a), T(b), T(valid)).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.any()


def test_window_gate(rng):
    a = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    b = rng.uniform(0, 640, (70, 2)).astype(np.float32)
    ob = rng.integers(0, 8, 70).astype(np.int32)
    r = rng.uniform(20, 200, 50).astype(np.float32)
    lo = rng.integers(0, 4, 50).astype(np.int32)
    hi = lo + 2
    for args, kw in (((100.0,), {}), ((T(r),), dict(per_row_radius=True)),
                     ((60.0,), dict(octave_b=ob, min_level=lo, max_level=hi)),
                     ((60.0,), dict(octave_b=ob, min_level=2, max_level=5))):
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        tkw = {k: (T(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        jargs = tuple(jnp.asarray(x.numpy()) if torch.is_tensor(x) else x for x in args)
        j = np.asarray(jm.window_gate(jnp.asarray(a), jnp.asarray(b), *jargs, **jkw))
        t = tm.window_gate(T(a), T(b), *args, **tkw).numpy()
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("mutual,check_rotation", [(True, False), (False, True),
                                                   (True, True)])
def test_match_mutual_and_rotation(rng, mutual, check_rotation):
    n, m = 300, 280
    da = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    db = np.concatenate([da[:200] ^ (rng.random((200, 8)) < 0.02).astype(np.uint32),
                         rng.integers(0, 2 ** 32, (80, 8), dtype=np.uint32)])
    db = db[rng.permutation(m)]
    aa = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    ab = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    gate = rng.random((n, m)) < 0.7
    kw = dict(max_dist=jm.TH_LOW, nn_ratio=0.9, mutual=mutual,
              check_rotation=check_rotation, unique=True)
    ji, jd, jok = jm.match(jnp.asarray(da), jnp.asarray(db), allowed=jnp.asarray(gate),
                           angle_a=jnp.asarray(aa), angle_b=jnp.asarray(ab), **kw)
    ti, td, tok = tm.match(i32(da), i32(db), allowed=T(gate), angle_a=T(aa),
                           angle_b=T(ab), **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tok.any()
