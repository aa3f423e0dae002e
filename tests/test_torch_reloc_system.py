"""The port's place recognition and relocalisation inside SLAMSystem
against the JAX package's, on the CPU, from one shared state.

The state is tests/test_system_vo.py's JAX system after 12 oracle-feature
frames (at the SlamConfig defaults its keyframe database holds every
keyframe's BoW vector over the shipped vocabulary), carried into the port
through convert.py: the map, the host lists, the vocabulary and the
database. The RANSAC draws of `jax.random` cannot be repeated, so the test
records the sets JAX's `_relocalize` draws (its `epnp_ransac` is wrapped
to recompute them from its key, as epnp.py:209-212 does) and hands them to
the port through `_reloc_sets`.

Tolerances and why: BoW ids, active flags, candidate lists (in order),
accept decisions and counters equal; BoW weights within 1e-6 (f32 sums in
another order); the relocalised pose within 1e-3, the bound of
tests/test_torch_epnp.py's refined poses (EPnP's winner among four-point
hypotheses is decided by the eigensolver, the pose refined on its inliers
is not). After one keyframe integration on a JAX copy and on the port,
with keyframe culling made likelier (redundancy 0.5 on both) so that one
keyframe is culled, the databases agree slot by slot, the erased row
included.
"""

import copy
import threading
from dataclasses import replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam_tpu.solvers.epnp as jax_epnp
from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.pipeline.track_kernels import track_frame
from orb_slam_tpu.slam_map.covisibility import covisibility_weights as jax_covis
from orb_slam_tpu_torch.convert import database_from_numpy, vocabulary_from_numpy
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.slam_map.covisibility import covisibility_weights
from tests.test_system_vo import run_sequence
from tests.test_torch_system_map import _two_threads, port_system  # noqa: F401

T = torch.from_numpy
N_SLOTS = 200


@pytest.fixture(scope="module")
def jax_run():
    jsys, poses, _ = run_sequence(n_frames=12)
    assert jsys.db is not None and jsys.n_keyframes >= 3
    return jsys, SyntheticScene(n_points=500, seed=0), lateral_trajectory(14, step=0.08)


def jax_copy(jsys, **cfg):
    """A shallow copy of the JAX system whose host state and database can
    change without touching the fixture's."""
    a = copy.copy(jsys)
    a.cfg = dc_replace(jsys.cfg, enable_loop_closing=False, **cfg)
    a.free_kf, a.free_pt = list(jsys.free_kf), list(jsys.free_pt)
    a.kf_order, a.pt_forward = jsys.kf_order.copy(), jsys.pt_forward.copy()
    a.trajectory = list(jsys.trajectory)
    a.db = copy.copy(jsys.db)
    a.db.active, a.db.lock = jsys.db.active.copy(), threading.RLock()
    return a


def port_copy(jsys, **cfg):
    """The port's SLAMSystem holding the JAX system's state, vocabulary and
    database."""
    s = port_system(jsys)
    s.cfg = dc_replace(s.cfg, enable_loop_closing=False, **cfg)
    s.trajectory = list(jsys.trajectory)
    s.vocab = vocabulary_from_numpy(vars(jsys.vocab))
    s.db = database_from_numpy(s.vocab, dict(
        bow_ids=np.asarray(jsys.db.bow_ids), bow_w=np.asarray(jsys.db.bow_w),
        active=jsys.db.active), device="cpu")
    return s


def port_frame(jframe):
    return tsys.FrameData(*(T(np.array(v)) for v in (
        jframe.xy, np.asarray(jframe.desc).view(np.int32), jframe.octave, jframe.angle,
        jframe.valid)), jframe.frame_id, jframe.timestamp)


def assert_same_database(db_t, db_j):
    np.testing.assert_array_equal(db_t.active, db_j.active)
    np.testing.assert_array_equal(db_t.bow_ids.numpy(), np.asarray(db_j.bow_ids))
    np.testing.assert_allclose(db_t.bow_w.numpy(), np.asarray(db_j.bow_w), atol=1e-6)


def test_database_of_a_jax_run_is_the_ports_bow(jax_run):
    """Every live keyframe's row of the JAX database equals the port's
    compute_bow of that keyframe's descriptors; the other rows are empty."""
    jsys, _, _ = jax_run
    s = port_copy(jsys)
    m = s.map
    live = m.kf_valid.numpy()
    np.testing.assert_array_equal(jsys.db.active, live)
    for slot in np.where(live)[0]:
        ids, w, _ = s.db.compute_bow(m.kf_desc[slot], m.kf_feat_valid[slot])
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jsys.db.bow_ids[slot]))
        np.testing.assert_allclose(w.numpy(), np.asarray(jsys.db.bow_w[slot]), atol=1e-6)
    assert (np.asarray(jsys.db.bow_ids)[~live] == 2 ** 30).all()


def test_integration_adds_and_culling_erases_like_jax(jax_run):
    """One _integrate_keyframe of frame 12 on both: the new keyframe's BoW
    added, the culled keyframe's row erased, the databases equal slot by
    slot."""
    jsys, scene, poses = jax_run
    feats = scene.observe(poses[12], n_slots=N_SLOTS)
    frame = jsys.make_frame(features=feats)
    res = track_frame(jsys.map, frame.xy, frame.desc, frame.octave, frame.valid,
                      jnp.asarray(jsys.last_pose), jsys.K_dev, p_local=jsys.cfg.p_local,
                      width=jsys.cfg.camera.width, height=jsys.cfg.camera.height)
    n_in, pose = int(res.n_inliers), np.asarray(res.pose)
    a, b = jax_copy(jsys, kf_cull_redundancy=0.5), port_copy(jsys, kf_cull_redundancy=0.5)
    slot_a = a._integrate_keyframe(frame, res.obs, n_in, pose=pose)
    slot_b = b._integrate_keyframe(port_frame(frame), T(np.array(res.obs)), n_in,
                                   pose=pose)
    assert slot_a == slot_b and a.db.active[slot_a]
    np.testing.assert_array_equal(b.kf_order, a.kf_order)
    culled = np.where(jsys.db.active & ~a.db.active)[0]
    assert len(culled) >= 1 and b.mapping_counts["kf_culled"] == len(culled)
    assert_same_database(b.db, a.db)


def relocalize_both(jsys, feats, monkeypatch):
    """(JAX copy, port copy, JAX's result, the port's, the sets JAX drew)
    of one _relocalize of `feats` from the fixture's state."""
    a, b = jax_copy(jsys), port_copy(jsys)
    a.state = b.state = tsys.LOST
    sets = []
    ransac = jax_epnp.epnp_ransac

    def recorded(pw, uv, valid, inv_s2, K, key, **kw):
        logits = jnp.where(valid, 0.0, -jnp.inf)
        g = jax.random.gumbel(key, (128, pw.shape[0])) + logits[None, :]
        sets.append(np.asarray(jax.lax.top_k(g, 4)[1]))
        return ransac(pw, uv, valid, inv_s2, K, key, **kw)

    monkeypatch.setattr(jax_epnp, "epnp_ransac", recorded)
    jframe = a.make_frame(features=feats)
    ok_a = a._relocalize(jframe)
    queue = list(sets)
    b._reloc_sets = lambda valid: T(queue.pop(0))
    ok_b = b._relocalize(port_frame(jframe))
    assert not queue                         # as many EPnP calls as JAX
    # the candidate query itself, on both databases
    ids_a, w_a, _ = a.db.compute_bow(jframe.desc, jframe.valid)
    fb = port_frame(jframe)
    ids_b, w_b, _ = b.db.compute_bow(fb.desc, fb.valid)
    cands_a = a.db.detect_relocalisation_candidates(ids_a, w_a, np.asarray(jax_covis(a.map)))
    cands_b = b.db.detect_relocalisation_candidates(
        ids_b, w_b, covisibility_weights(b.map).numpy())
    assert cands_b == cands_a
    return a, b, ok_a, ok_b, sets


def test_relocalize_a_revisited_frame_like_jax(jax_run, monkeypatch):
    jsys, scene, poses = jax_run
    a, b, ok_a, ok_b, sets = relocalize_both(
        jsys, scene.observe(poses[3], n_slots=N_SLOTS), monkeypatch)
    assert ok_a and ok_b and len(sets) >= 1
    assert a.n_relocs == b.n_relocs == 1 and a.state == b.state == tsys.WORKING
    np.testing.assert_allclose(b.last_pose, np.asarray(a.last_pose), atol=1e-3)
    np.testing.assert_array_equal(b.velocity, np.eye(4, dtype=np.float32))
    assert b.trajectory[-1][0] == a.trajectory[-1][0]
    np.testing.assert_array_equal(b.local_mask.numpy(), np.asarray(a.local_mask))


def test_relocalize_garbage_fails_like_jax(jax_run, monkeypatch):
    rng = np.random.default_rng(5)
    feats = dict(xy=rng.uniform(0, 400, (N_SLOTS, 2)).astype(np.float32),
                 desc=rng.integers(0, 2 ** 32, (N_SLOTS, 8), dtype=np.uint32),
                 octave=np.zeros(N_SLOTS, np.int32),
                 angle=np.zeros(N_SLOTS, np.float32), valid=np.ones(N_SLOTS, bool))
    a, b, ok_a, ok_b, sets = relocalize_both(jax_run[0], feats, monkeypatch)
    assert not ok_a and not ok_b and sets == []
    assert a.n_relocs == b.n_relocs == 0 and b.state == tsys.LOST
