"""The port's loop closer against the JAX package's, on the CPU, from
states of one JAX run.

The run: tests/test_loop_reloc_e2e.py:118-151's oracle scenario (a turn
inside a ring world, the recent half of the map drifted through a Sim3 at
frame 60) through the JAX SLAMSystem, every LoopCloser.process call
recorded with a copy of the system just before it and the minimal sets
JAX's sim3_ransac draws (recomputed from its key, as
orb_slam_tpu/solvers/sim3.py:45-47 draws them). Each state goes into the
port through convert.py (the map, the host lists, the vocabulary, the
database, and `loop_closer_from_state` for the consistent groups).

Checks and tolerances:
  * `detect` over the recorded keyframes in order: the candidates, the
    consistent groups and the database row it adds equal JAX's (BoW
    weights within 1e-6);
  * `search_by_sim3` and `project_loop_points` on the closing state under
    JAX's accepted Sim3: the flags equal, the indices equal where set;
  * `fuse_points_into_keyframes` on the closing state's corrected map, its
    loop points into the corrected group: kf_obs, pt_valid, the counters
    and the composed remap equal (integers), and the run hits the
    last-writer collision of mapping_kernels.py:428-430 (a later row
    writes a feature back after an earlier row bound it);
  * one whole `_run_loop_closing` from the closing state with JAX's sets
    injected through `_sim3_sets`: the same decision and candidate,
    n_loops_closed, loop_edges and pt_forward equal; S12 within 1e-4; the
    corrected keyframe poses within 1e-3; the points within 1e-3, except
    those seen by at most two keyframes (their depth rests on one small
    baseline, tests/test_torch_system_map.py's bound of 1.5e-2).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam_tpu.pipeline.loop_closing as jlc
from orb_slam_tpu.io.synthetic import SyntheticScene
from orb_slam_tpu.slam_map.observations import observation_table
from orb_slam_tpu_torch.convert import (
    database_from_numpy, loop_closer_from_state, map_state_from_numpy,
    vocabulary_from_numpy,
)
from orb_slam_tpu_torch.ops import scatter
from orb_slam_tpu_torch.pipeline import loop_closing as tlc
from orb_slam_tpu_torch.pipeline import mapping_kernels as tmk
import tests.test_loop_reloc_e2e as jax_e2e
from tests.test_torch_system_map import _two_threads, port_system  # noqa: F401

T = torch.from_numpy


def _sets_of(valid, key, H=300):
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (H, valid.shape[0])) + logits[None, :]
    return np.asarray(jax.lax.top_k(g, 3)[1])


@pytest.fixture(scope="module")
def jax_run():
    """The JAX run's recorded passes: per LoopCloser.process call, a copy
    of the system just before it, the keyframe slot, the sets drawn, the
    result, and for the accepted call the candidate and S12."""
    scene = SyntheticScene(n_points=1500, seed=5, extent=(0, 4.0, 0),
                           depth_range=(7.0, 13.0), ring=True)
    n_slots = 250
    sys_ = jax_e2e.make_system(scene, n_slots, enable_relocalisation=False,
                       max_frames_between_kf=6, min_frames_between_kf=4,
                       kf_tracked_ratio=1.5, track_radius=25.0)
    passes = []
    process, correct, ransac, fuse = (jlc.LoopCloser.process, jlc.LoopCloser.correct,
                                      jlc.sim3_ransac, jlc.fuse_points_into_keyframes)

    def recorded_fuse(m, loop_pts, dst_arr, K, **kw):
        passes[-1]["fuse"] = (m, np.asarray(loop_pts), np.asarray(dst_arr), kw)
        return fuse(m, loop_pts, dst_arr, K, **kw)

    def recorded_ransac(p1, p2, uv1, uv2, valid, s2_1, s2_2, K, key, **kw):
        passes[-1]["sets"].append(_sets_of(valid, key))
        return ransac(p1, p2, uv1, uv2, valid, s2_1, s2_2, K, key, **kw)

    def recorded_correct(self, system, new_kf, cand, S12):
        passes[-1].update(cand=int(cand), S12=tuple(np.asarray(x) for x in S12))
        return correct(self, system, new_kf, cand, S12)

    def recorded_process(self, system, new_kf):
        a = copy.copy(system)
        a.free_kf, a.free_pt = list(system.free_kf), list(system.free_pt)
        a.kf_order, a.pt_forward = system.kf_order.copy(), system.pt_forward.copy()
        a.db = copy.copy(system.db)
        a.db.active = system.db.active.copy()
        passes.append(dict(before=a, slot=int(new_kf), sets=[],
                           groups=copy.deepcopy(self.consistent_groups),
                           last=self.last_loop_kf_counter))
        ok = process(self, system, new_kf)
        passes[-1].update(ok=ok, after=dict(
            map=system.map, pt_forward=system.pt_forward.copy(),
            last_pose=np.array(system.last_pose),
            groups=copy.deepcopy(self.consistent_groups),
            db=(np.asarray(system.db.bow_ids), np.asarray(system.db.bow_w),
                system.db.active.copy())))
        return ok

    mp = pytest.MonkeyPatch()
    mp.setattr(jlc.LoopCloser, "process", recorded_process)
    mp.setattr(jlc.LoopCloser, "correct", recorded_correct)
    mp.setattr(jlc, "sim3_ransac", recorded_ransac)
    mp.setattr(jlc, "fuse_points_into_keyframes", recorded_fuse)
    try:
        poses = [jax_e2e.yaw_pose(0.0, [-0.5 + 0.0625 * i, 0.0, 0.0]) for i in range(8)]
        for i in range(116):
            yaw = 2 * np.pi * i / 96
            poses.append(jax_e2e.yaw_pose(yaw, [3.0 * np.sin(yaw), 0.0,
                                        3.0 * (np.cos(yaw) - 1.0)]))
        for fi, T_cw in enumerate(poses):
            sys_.process(features=scene.observe(T_cw, n_slots=n_slots, pix_noise=0.4))
            if fi == 60:
                jax_e2e.TestLoopClosing._inject_drift(None, sys_, 1.15, [0.4, 0.0, 0.2])
            if any(p["ok"] for p in passes):
                break
    finally:
        mp.undo()
    closing = next(p for p in passes if p["ok"])
    return passes, closing


def port_of(jsys, groups, last):
    """The port's SLAMSystem holding a JAX system's state, vocabulary,
    database and loop closer."""
    s = port_system(jsys)
    s.cfg.enable_relocalisation = False
    s.vocab = vocabulary_from_numpy(vars(jsys.vocab))
    s.db = database_from_numpy(s.vocab, dict(
        bow_ids=np.asarray(jsys.db.bow_ids), bow_w=np.asarray(jsys.db.bow_w),
        active=jsys.db.active), device="cpu")
    s.loop_closer = loop_closer_from_state(s.db, s.cfg, groups, last)
    return s


def test_detect_over_the_recorded_keyframes_like_jax(jax_run):
    passes, closing = jax_run
    seq = passes[max(0, passes.index(closing) - 8):passes.index(closing) + 1]
    n_cands = 0
    for p in seq:
        s = port_of(p["before"], p["groups"], p["last"])
        cands, _, _ = s.loop_closer.detect(s, p["slot"])
        assert [(set(g), c) for g, c in s.loop_closer.consistent_groups] == [
            (set(int(k) for k in g), c) for g, c in p["after"]["groups"]] or p["ok"]
        ids, w, act = p["after"]["db"]
        np.testing.assert_array_equal(s.db.active, act)
        np.testing.assert_array_equal(s.db.bow_ids.numpy(), ids)
        np.testing.assert_allclose(s.db.bow_w.numpy(), w, atol=1e-6)
        n_cands += len(cands)
        if p["ok"]:
            assert closing["cand"] in cands
    assert n_cands >= 1


def closing_port(closing):
    return port_of(closing["before"], closing["groups"], closing["last"])


def test_guided_and_projection_matchers_like_jax(jax_run):
    _, closing = jax_run
    j = closing["before"]
    s = closing_port(closing)
    kf, cand = closing["slot"], closing["cand"]
    s12 = [jnp.asarray(x) for x in closing["S12"]]
    t12 = [T(np.array(x)) for x in closing["S12"]]
    ia, oa = jlc.search_by_sim3(j.map, kf, cand, *s12, j.K_dev)
    ib, ob = tlc.search_by_sim3(s.map, kf, cand, *t12, s.K_dev)
    np.testing.assert_array_equal(ob.numpy(), np.asarray(oa))
    np.testing.assert_array_equal(ib.numpy()[ob.numpy()], np.asarray(ia)[np.asarray(oa)])
    assert int(ob.sum()) >= 20
    P = s.map.pt_valid.shape[0]
    rng = np.random.default_rng(0)
    loop_mask = rng.random(P) < 0.8
    matched_pts = rng.random(P) < 0.05
    matched_feat = np.asarray(oa)
    kw = dict(width=float(j.cfg.camera.width), height=float(j.cfg.camera.height),
              bounds=j.img_bounds)
    fa, pa = jlc.project_loop_points(j.map, kf, jnp.asarray(loop_mask), jnp.asarray(matched_feat),
                                     jnp.asarray(matched_pts), *s12, j.map.kf_pose[cand],
                                     j.K_dev, **kw)
    fb, pb = tlc.project_loop_points(s.map, kf, T(loop_mask), T(matched_feat),
                                     T(matched_pts), *t12, s.map.kf_pose[cand], s.K_dev, **kw)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(pa))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(fa))
    assert int(pb.sum()) >= 5


def test_fuse_points_into_keyframes_like_jax_with_a_collision(jax_run, monkeypatch):
    """The fuse of the closing pass on JAX's own inputs: its corrected map,
    the loop side's points, the corrected group as destinations."""
    _, closing = jax_run
    j = closing["before"]
    m_j, loop_pts, dsts, kw = closing["fuse"]
    P = loop_pts.shape[0]
    ma, ra = jlc.fuse_points_into_keyframes(m_j, jnp.asarray(loop_pts), jnp.asarray(dsts),
                                            j.K_dev, **kw)
    undone = []
    set_last = scatter.set_last

    def watched(base, index, values):
        idx = index.numpy()
        val = values.numpy()
        b = base.numpy()
        for f in np.unique(idx):
            rows = np.where(idx == f)[0]
            binds = rows[val[rows] != b[f]]
            if len(binds) and rows[-1] > binds[0] and val[rows[-1]] == b[f]:
                undone.append(int(f))
        return set_last(base, index, values)

    monkeypatch.setattr(tmk, "set_last", watched)
    m_t = map_state_from_numpy({k: np.asarray(v) for k, v in m_j._asdict().items()},
                               device="cpu")
    mb, rb = tmk.fuse_points_into_keyframes(m_t, T(loop_pts), dsts, T(np.asarray(j.K_dev)),
                                            **kw)
    for f in ("kf_obs", "pt_valid", "pt_visible", "pt_found"):
        np.testing.assert_array_equal(getattr(mb, f).numpy(), np.asarray(getattr(ma, f)), f)
    np.testing.assert_array_equal(rb.numpy(), np.asarray(ra))
    assert undone, "no last-writer collision in this fuse"
    assert (np.asarray(ra) != np.arange(P)).sum() >= 1


def test_whole_loop_closing_pass_like_jax(jax_run):
    _, closing = jax_run
    j = closing["before"]
    s = closing_port(closing)
    queue = [T(x) for x in closing["sets"]]
    s.loop_closer._sim3_sets = lambda valid: queue.pop(0)
    hit = {}
    correct = s.loop_closer.correct

    def watched(system, new_kf, cand, S12):
        hit.update(cand=cand, S12=[x.numpy() for x in S12])
        return correct(system, new_kf, cand, S12)

    s.loop_closer.correct = watched
    n0 = s.n_loops_closed
    s._run_loop_closing(closing["slot"])
    assert not queue                       # as many RANSAC calls as JAX
    assert s.n_loops_closed == n0 + 1 and hit["cand"] == closing["cand"]
    for a, b in zip(hit["S12"], closing["S12"]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    after = closing["after"]
    ma = after["map"]
    np.testing.assert_array_equal(s.map.loop_edges.numpy(), np.asarray(ma.loop_edges))
    np.testing.assert_array_equal(s.pt_forward, after["pt_forward"])
    np.testing.assert_array_equal(s.map.pt_valid.numpy(), np.asarray(ma.pt_valid))
    live = np.asarray(ma.kf_valid)
    np.testing.assert_allclose(s.map.kf_pose.numpy()[live], np.asarray(ma.kf_pose)[live],
                               atol=1e-3)
    _, _, o_valid = observation_table(ma)
    seen = np.asarray(o_valid).sum(-1)
    valid = np.asarray(ma.pt_valid)
    d = np.abs(s.map.pt_pos.numpy() - np.asarray(ma.pt_pos)).max(-1)
    assert d[valid & (seen >= 3)].max() <= 1e-3
    assert d[valid].max() <= 1.5e-2
    np.testing.assert_allclose(s.last_pose, after["last_pose"], atol=1e-3)
