"""Long-run capacity of the port (tests/test_longrun.py's two tests, on a
map small enough that both slot pools fill), and one integration into
recycled point slots against the JAX package.

The run: tests/test_longrun.py's scene and trajectory (2500 points over
60 m, sideways at 0.09 m a frame, a keyframe every 3-8 frames) with
oracle features, cut to 100 frames into MapConfig(10, 512) so that it
fills: the point pool wraps (more slots written than it holds, through
pipeline/system.py's recycled point slots and their `pt_forward` repair)
and `free_kf` empties, so `_need_new_keyframe` refuses keyframes and a
culled keyframe's slot goes to a later one. Checks: JAX's (>= 85% of the
frames tracked, WORKING, free lists against the validity masks, the ATE
under 5% of the path, an acyclic spanning tree) and
profile_paths.slot_failures (`free_pt` exactly the invalid slots,
`pt_forward` sane, one spanning-tree root); a repeat of the run gives the
same bits.

Parity: both packages run the same oracle frames up to the first
integration that writes a point into a recycled slot; JAX's state just
before it (its map through convert.py, and `free_pt`, `free_kf`,
`kf_order`, `kf_counter` and `pt_forward` as JAX holds them live) goes
into the port, and that one `_integrate_keyframe` runs in both. The slots
written, the free lists, `kf_order` and `pt_forward` are equal; the map
is held to tests/test_torch_system_map.py's bounds (ROADMAP C6, C7):
points seen by >= 3 keyframes 1e-3, the others 1.5e-2, at most 2
validity flips, under 0.5% of kf_obs differing; poses 2e-4, twice that
file's: this integration makes the map's third keyframe (frame 6), which
only two fixed gauge keyframes constrain, and its pose differs by 1.02e-4
(translation; rotation 7.3e-5) though both packages ran the same LM
iterations (phase 2 stopped after 3 in each: JAX's output is reached at 3
and moves at 2), so this is the f32 order of the sums (C7), not a stop
flip.

A session reload (slam_map/serialization.py:184-185 here, JAX's
serialization.py:141-143) rebuilds both free lists sorted from the masks,
in both packages alike. The live system pops `free_kf` from the front and
appends a culled slot at its end, so after a cull a reloaded system can
take another slot next than the live one would; `free_pt` is kept sorted
live as well, so it reloads as it was.
"""

import copy

import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene as JaxScene
from orb_slam_tpu.pipeline import system as jsys
from orb_slam_tpu.slam_map import MapConfig as JaxMapConfig
from orb_slam_tpu.slam_map import serialization as jser
from orb_slam_tpu.slam_map.observations import observation_table
from orb_slam_tpu_torch.convert import map_state_from_numpy
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu_torch.io.trajectory import ate_rmse, camera_centers_from_cw
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.profile_paths import SlotRecord, slot_failures
from orb_slam_tpu_torch.slam_map import MapConfig
from orb_slam_tpu_torch.slam_map import serialization as tser
from tests.test_torch_system_map import _two_threads  # noqa: F401 (autouse)

N_FRAMES = 100
SCENE = dict(n_points=2500, seed=33, extent=(30.0, 5.0, 4.0), depth_range=(5.0, 12.0))
MAP = dict(max_keyframes=10, max_points=512, n_features=200)
OPTIONS = dict(p_local=512, n_triangulation_neighbors=3, n_fuse_neighbors=2,
               local_ba_window=6, enable_loop_closing=False,
               enable_relocalisation=False, kf_tracked_ratio=1.2,
               min_frames_between_kf=3, max_frames_between_kf=8)
POSES = lateral_trajectory(N_FRAMES, step=0.09)


def port_system(scene):
    return tsys.SLAMSystem(tsys.SlamConfig(camera=scene.camera_model(), orb=None,
                                           map=MapConfig(**MAP), **OPTIONS),
                           device="cpu")


def jax_system(scene):
    cfg = jsys.SlamConfig(camera=scene.camera_model(), map=JaxMapConfig(**MAP),
                          **OPTIONS)
    cfg.orb = None
    return jsys.SLAMSystem(cfg)


def run_port(session=None):
    """(system, poses out, SlotRecord) of the port over the whole run; with
    a `session` path, the session is saved there after the first frame
    that leaves `free_kf` out of order, and the third item is (the
    SlotRecord, that frame's free_kf)."""
    scene = SyntheticScene(**SCENE)
    s = port_system(scene)
    rec = SlotRecord(s)
    out, unsorted = [], None
    with rec.recording():
        for p in POSES:
            out.append(s.process(features=scene.observe(p, n_slots=200)))
            if session and unsorted is None and s.free_kf != sorted(s.free_kf):
                tser.save_session(session, s)
                unsorted = list(s.free_kf)
    return s, out, (rec if session is None else (rec, unsorted))


@pytest.fixture(scope="module")
def long_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("longrun") / "session.npz")
    s, out, (rec, unsorted) = run_port(path)
    return s, out, rec, path, unsorted


def test_capacity_stability(long_run):
    s, out, rec, _, _ = long_run
    tracked = [i for i, T in enumerate(out) if T is not None]
    assert len(tracked) > 0.85 * N_FRAMES and s.state == tsys.WORKING
    # both pools filled: the point pool wrapped into recycled slots, and
    # keyframes were refused while free_kf was empty
    assert len(rec.written) > MAP["max_points"] and rec.recycled > 0
    assert rec.refused_full > 0
    # a culled keyframe's slot went to a later keyframe
    assert rec.culls and rec.replaced(rec.culls)
    assert s.kf_counter > MAP["max_keyframes"]
    # tests/test_longrun.py's hygiene, and the rest of slot_failures
    pt_valid, kf_valid = s.map.pt_valid.numpy(), s.map.kf_valid.numpy()
    assert len(s.free_pt) == int((~pt_valid).sum())
    assert len(set(s.free_pt)) == len(s.free_pt)
    assert set(s.free_kf).isdisjoint(np.where(kf_valid)[0])
    assert slot_failures(s) == []
    C_est = camera_centers_from_cw(np.stack([out[i] for i in tracked]))
    C_gt = camera_centers_from_cw(POSES[tracked])
    rmse, _ = ate_rmse(C_est, C_gt)
    length = np.linalg.norm(np.diff(C_gt, axis=0), axis=1).sum()
    assert rmse < 0.05 * length, f"ATE {rmse:.4f} over {length:.2f} m"


def test_repeat_gives_the_same_bits(long_run):
    s1, out1, rec1, _, _ = long_run
    s2, out2, rec2 = run_port()
    assert [T is None for T in out1] == [T is None for T in out2]
    for a, b in zip(out1, out2):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for name in ("kf_pose", "pt_pos", "pt_valid", "kf_valid", "kf_obs",
                 "spanning_parent"):
        np.testing.assert_array_equal(getattr(s1.map, name).numpy(),
                                      getattr(s2.map, name).numpy(), err_msg=name)
    assert (s1.free_pt, s1.free_kf) == (s2.free_pt, s2.free_kf)
    np.testing.assert_array_equal(s1.pt_forward, s2.pt_forward)
    assert rec1.written == rec2.written and rec1.culls == rec2.culls


def test_session_reload_sorts_the_free_lists_alike(long_run, tmp_path):
    """The session saved when a cull first left the live free_kf out of
    order, loaded into each package."""
    s, _, _, path, unsorted = long_run
    assert unsorted is not None and unsorted != sorted(unsorted)
    t = tser.load_session(path, port_system(SyntheticScene(**SCENE)))
    j = jser.load_session(path, jax_system(JaxScene(**SCENE)))
    assert t.free_kf == list(j.free_kf) == sorted(unsorted)
    assert t.free_kf[0] != unsorted[0]      # the next slot differs from live
    assert t.free_pt == list(j.free_pt) == sorted(t.free_pt)
    # the end of the run, saved and loaded again: free_pt as it was live
    out = str(tmp_path / "end.npz")
    tser.save_session(out, s)
    assert tser.load_session(out, port_system(SyntheticScene(**SCENE))).free_pt == s.free_pt


def jax_until_recycled():
    """Run JAX over the frames until its first integration that writes a
    point into a slot that held one before. Returns (its state and the
    integration's arguments just before it, the JAX system just after it,
    the slots it wrote)."""
    scene = JaxScene(**SCENE)
    js = jax_system(scene)
    used, hit = set(), {}
    insert, integrate = jsys.insert_new_points, js._integrate_keyframe
    written = []

    def insert_new_points(m, kf, nb, cand, free):
        m, n = insert(m, kf, nb, cand, free)
        written.extend(int(p) for p in np.asarray(free)[:int(n)])
        return m, n

    def integrate_keyframe(frame, obs, n_inliers, pose=None, abort=None):
        before = dict(
            map=js.map, free_pt=list(js.free_pt), free_kf=list(js.free_kf),
            kf_order=js.kf_order.copy(), pt_forward=js.pt_forward.copy(),
            local_mask=js.local_mask, last_pose=np.array(js.last_pose),
            velocity=np.array(js.velocity),
            **{k: getattr(js, k) for k in ("state", "kf_counter", "frame_id",
                                           "last_kf_frame", "last_kf_slot",
                                           "ref_kf_tracked")})
        del written[:]
        slot = integrate(frame, obs, n_inliers, pose=pose, abort=abort)
        if any(p in used for p in written):
            hit.update(before=before, args=(frame, np.array(obs), n_inliers,
                                            np.asarray(pose)), slot=slot,
                       written=list(written))
        used.update(written)
        return slot

    js._integrate_keyframe = integrate_keyframe
    jsys.insert_new_points = insert_new_points
    try:
        for i, p in enumerate(POSES):
            js.process(features=scene.observe(p, n_slots=200))
            if js.state == jsys.WORKING and not used:
                used.update(int(k) for k in np.where(np.asarray(js.map.pt_valid))[0])
            if hit:
                break
    finally:
        jsys.insert_new_points = insert
    assert hit, "no integration wrote into a recycled slot"
    return hit, js


@pytest.fixture(scope="module")
def recycled():
    hit, js = jax_until_recycled()
    b = hit["before"]
    scene = SyntheticScene(**SCENE)
    t = port_system(scene)
    t.map = map_state_from_numpy({k: np.asarray(v) for k, v in b["map"]._asdict().items()},
                                 device="cpu")
    for k in ("state", "kf_counter", "frame_id", "last_kf_frame", "last_kf_slot",
              "ref_kf_tracked", "free_pt", "free_kf", "kf_order", "pt_forward",
              "last_pose", "velocity"):
        setattr(t, k, copy.copy(b[k]))
    t.local_mask = (None if b["local_mask"] is None
                    else torch.from_numpy(np.array(b["local_mask"])))
    frame, obs, n_in, pose = hit["args"]
    tframe = tsys.FrameData(*(torch.from_numpy(np.array(v)) for v in (
        frame.xy, np.asarray(frame.desc).view(np.int32), frame.octave, frame.angle,
        frame.valid)), frame.frame_id, frame.timestamp)
    rec = SlotRecord(t)
    with rec.recording():
        slot = t._integrate_keyframe(tframe, torch.from_numpy(obs), n_in, pose=pose)
    return hit, js, t, slot, rec


def test_recycled_integration_slots_match_jax(recycled):
    hit, js, t, slot, rec = recycled
    assert any(p < len(hit["before"]["free_pt"]) for p in hit["written"])
    assert slot == hit["slot"]
    assert rec.written == hit["written"]
    assert t.free_pt == list(js.free_pt) and t.free_kf == list(js.free_kf)
    assert t.kf_counter == js.kf_counter
    np.testing.assert_array_equal(t.kf_order, js.kf_order)
    np.testing.assert_array_equal(t.pt_forward, js.pt_forward)
    assert slot_failures(t) == []


def test_recycled_integration_map_matches_jax(recycled):
    hit, js, t, _, _ = recycled
    a = js.map
    np.testing.assert_allclose(t.map.kf_pose.numpy(), np.asarray(a.kf_pose), atol=2e-4)
    pv_a, pv_t = np.asarray(a.pt_valid), t.map.pt_valid.numpy()
    n_obs = np.asarray(observation_table(a)[2]).sum(1)
    d = np.abs(t.map.pt_pos.numpy() - np.asarray(a.pt_pos)).max(1)
    assert d[pv_a & pv_t & (n_obs >= 3)].max() < 1e-3
    assert d[pv_a & pv_t].max() < 1.5e-2
    assert (pv_a != pv_t).sum() <= 2
    assert (np.asarray(a.kf_obs) != t.map.kf_obs.numpy()).mean() < 0.005
    np.testing.assert_array_equal(t.map.kf_valid.numpy(), np.asarray(a.kf_valid))
    np.testing.assert_array_equal(t.map.spanning_parent.numpy(),
                                  np.asarray(a.spanning_parent))
