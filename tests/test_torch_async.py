"""The port's AsyncSLAMSystem (pipeline/async_system.py) on the CPU, against
the JAX package's where the two can be made deterministic, and on its
own for the thread protocol (tests/test_async_system.py and
tests/test_async_loop.py on the port).

Parity: a JAX AsyncSLAMSystem in oracle-features mode runs 12 frames of
tests/test_async_system.py's scene with `finish()` after every frame,
its state is carried into the port's through convert.py, and both run
the next frames, each drained after every frame. The drain makes both
runs deterministic: every keyframe is integrated before the next frame
is tracked, and `_mapper_accepting` is True at every keyframe decision.
Run as a module (`python -m tests.test_torch_async`), it prints how far
the first integration's BA moves the new keyframe in each package, and
their keyframe poses' largest difference (ROADMAP C16).

Tolerances: tracked poses within 1e-4 (tests/test_torch_system_map.py's
bound for one integration); the keyframe decisions, the host lists and the
counters equal. The integration's BA is held to the
port's own sequential SLAMSystem run from the same state, which the
drained async run must equal bit for bit, because JAX's f32 BA takes no
camera step on this keyframe (ROADMAP C16). The second witness for that:
JAX's own bundle_adjust run again in float64 on the same inputs moves the
keyframe as the port's does, and after its phase 2 agrees with the port
at tests/test_torch_system_map.py's bounds.

The thread protocol runs the port alone: tracking with a live mapper,
stop/release, a reset while a caller owns the park window (in a thread
with a time limit: it must not deadlock), an error on the mapper thread
raised by `finish()`, the counter deltas under a short switch interval,
and the system with loop closing and relocalisation on.
"""

import sys
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene as JaxScene
from orb_slam_tpu.io.synthetic import lateral_trajectory as jax_trajectory
from orb_slam_tpu_torch.convert import map_state_from_numpy
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.pipeline.async_system import AsyncSLAMSystem
from orb_slam_tpu_torch.slam_map.map_state import MapConfig
from tests.test_async_system import make_async_system

N_SLOTS = 200
SCENE_SEED = 7
CARRY_AT = 12
N_AFTER = 6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for torch while this module runs (as
    tests/test_torch_system_map.py: the sums keep one order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_async(scene, **overrides):
    """The port's AsyncSLAMSystem in oracle-features mode on the CPU, with
    tests/test_async_system.py's configuration."""
    kw = dict(enable_loop_closing=False, enable_relocalisation=False)
    kw.update(overrides)
    cfg = tsys.SlamConfig(
        camera=CameraModel(scene.fx, scene.fy, scene.cx, scene.cy,
                           width=scene.width, height=scene.height),
        orb=None, map=MapConfig(max_keyframes=32, max_points=2048,
                                n_features=N_SLOTS),
        p_local=512, n_triangulation_neighbors=3, n_fuse_neighbors=2,
        local_ba_window=6, **kw)
    return AsyncSLAMSystem(cfg, device="cpu")


def carry_state(jsys, s):
    """The JAX system's state into the port's system `s`."""
    s.map = map_state_from_numpy(
        {k: np.asarray(v) for k, v in jsys.map._asdict().items()}, device="cpu")
    for name in ("state", "kf_counter", "frame_id", "last_kf_frame", "last_kf_slot",
                 "ref_kf_tracked"):
        setattr(s, name, getattr(jsys, name))
    s.free_kf, s.free_pt = list(jsys.free_kf), list(jsys.free_pt)
    s.kf_order = jsys.kf_order.copy()
    s.pt_forward = jsys.pt_forward.copy()
    s.last_pose = np.array(jsys.last_pose)
    s.velocity = np.array(jsys.velocity)
    s.trajectory = list(jsys.trajectory)
    s.local_mask = (None if jsys.local_mask is None
                    else torch.from_numpy(np.array(jsys.local_mask)))


@pytest.fixture(scope="module")
def drained_runs():
    return drained()


def drained(seed=SCENE_SEED, carry_at=CARRY_AT, n_after=N_AFTER):
    """From the state JAX's drained run reaches after `carry_at` frames,
    the next `n_after` frames through JAX's AsyncSLAMSystem, the port's
    and the port's sequential SLAMSystem, the async ones drained after
    every frame. Returns (the poses out of each, the three systems); the
    JAX system's `ba_calls` holds the arguments and result of each of its
    bundle_adjust calls after the carry."""
    import orb_slam_tpu.pipeline.system as jax_system_module

    ba = jax_system_module.bundle_adjust
    ba_calls = []

    def recorded_ba(state, K, cam_opt, pt_opt, **kw):
        out = ba(state, K, cam_opt, pt_opt, **kw)
        ba_calls.append((state, K, cam_opt, pt_opt, kw, out))
        return out

    scene = JaxScene(n_points=500, seed=seed)
    poses = jax_trajectory(carry_at + n_after, step=0.08)
    feats = [scene.observe(p, n_slots=N_SLOTS) for p in poses]
    jsys = make_async_system(scene, N_SLOTS)
    s = port_async(scene)
    seq = tsys.SLAMSystem(s.cfg, device="cpu")
    try:
        for f in feats[:carry_at]:
            jsys.process(features=f)
            jsys.finish()
        assert jsys.state == tsys.WORKING
        carry_state(jsys, s)
        carry_state(jsys, seq)
        jsys.ba_calls = ba_calls
        jax_system_module.bundle_adjust = recorded_ba
        out = ([], [], [])
        for f in feats[carry_at:]:
            out[0].append(jsys.process(features=f))
            jsys.finish()
            out[1].append(s.process(features=f))
            s.finish()
            out[2].append(seq.process(features=f))
    finally:
        jax_system_module.bundle_adjust = ba
        jsys.close()
        s.close()
    return out, (jsys, s, seq)


def test_drained_async_matches_jax(drained_runs):
    """Tracking, the keyframe decisions and the integration's host lists
    against JAX. The integration's BA is held to the port's sequential
    system below: on this keyframe JAX's BA takes no camera step (a point
    seen once has a block whose f32 inverse JAX's LAPACK returns
    non-finite, which poisons the reduced right-hand side; ROADMAP C16),
    where the port's moves the new keyframe by 3.2e-3."""
    (out_j, out_t, _), (jsys, s, _) = drained_runs
    assert all(p is not None for p in out_j) and all(p is not None for p in out_t)
    assert s.kf_counter == jsys.kf_counter == 4
    first_kf = s.kf_order.tolist().index(3)
    n_tracked_before = int(s.map.kf_frame_id[first_kf]) - CARRY_AT + 1
    for pj, pt in zip(out_j[:n_tracked_before], out_t[:n_tracked_before]):
        np.testing.assert_allclose(pt, np.asarray(pj), atol=1e-4)
    assert s.free_kf == jsys.free_kf and s.free_pt == jsys.free_pt
    assert s.last_kf_slot == jsys.last_kf_slot
    np.testing.assert_array_equal(s.kf_order, jsys.kf_order)
    np.testing.assert_array_equal(s.pt_forward, jsys.pt_forward)
    np.testing.assert_array_equal(s.map.kf_valid.numpy(), np.asarray(jsys.map.kf_valid))
    np.testing.assert_array_equal(s.map.pt_valid.numpy(), np.asarray(jsys.map.pt_valid))


def test_c16_jax_ba_in_f64_moves_the_keyframe_as_the_port(drained_runs):
    """A second witness for ROADMAP C16: JAX's own bundle_adjust, run
    again in float64 on the inputs of the integration's two BA calls
    (phase 1, then phase 2), moves the new keyframe by 3.2e-3 in each,
    where its float32 run moved it not at all. The port's bundle_adjust
    on the same f32 inputs moves it as far (within 10%), and after phase
    2, the integration's result, agrees with JAX's f64 run at
    tests/test_torch_system_map.py's bounds: keyframe poses within 1e-4
    and the points seen by >= 3 keyframes within 1e-3 (measured 6.5e-6
    and 8.0e-5). Phase 1 alone is not held to them: its 5 LM iterations
    stop at a 1e-4 relative gain, which f32 and f64 reach at other
    iterates (measured 2.3e-4 and 4.0e-3). Points seen by fewer
    keyframes move along their rays and are not held."""
    import jax

    from orb_slam_tpu.solvers.local_ba import bundle_adjust as jax_ba
    from orb_slam_tpu_torch.solvers.local_ba import bundle_adjust as port_ba

    _, (jsys, s, _) = drained_runs
    slot = s.kf_order.tolist().index(3)
    assert len(jsys.ba_calls) == 2
    for state, K, cam_opt, pt_opt, kw, out32 in jsys.ba_calls:
        before = np.asarray(state.kf_pose[slot])
        assert np.abs(np.asarray(out32[0].kf_pose[slot]) - before).max() == 0.0
        with jax.enable_x64(True):
            st64 = jax.tree_util.tree_map(
                lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, state)
            out64 = jax_ba(st64, jnp.asarray(K, jnp.float64), cam_opt, pt_opt, **kw)
            kf64, pt64 = np.asarray(out64[0].kf_pose), np.asarray(out64[0].pt_pos)
        moved64 = np.abs(kf64[slot] - before).max()
        assert moved64 > 1e-3
        port = port_ba(
            map_state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()},
                                 device="cpu"),
            torch.from_numpy(np.asarray(K)), torch.from_numpy(np.asarray(cam_opt)),
            torch.from_numpy(np.asarray(pt_opt)), **kw)[0]
        moved = np.abs(port.kf_pose.numpy()[slot] - before).max()
        assert abs(moved - moved64) <= 0.1 * moved64, (moved, moved64)
    live = np.asarray(state.kf_valid)
    np.testing.assert_allclose(port.kf_pose.numpy()[live], kf64[live], atol=1e-4)
    obs = np.asarray(state.kf_obs)[live]
    seen = np.bincount(obs[obs >= 0].ravel(), minlength=len(pt64))
    strong = np.asarray(pt_opt) & (seen >= 3)
    np.testing.assert_allclose(port.pt_pos.numpy()[strong], pt64[strong], atol=1e-3)


def test_drained_async_matches_sequential(drained_runs):
    """The threads change nothing: the drained AsyncSLAMSystem's map equals
    the sequential system's bit for bit, and its poses agree to 1e-6 (the
    async tracker keeps its own pose where the sequential one adopts the
    BA-refined keyframe pose, `_publish_mapped_pose`)."""
    (_, out_t, out_s), (_, s, seq) = drained_runs
    for pt, ps in zip(out_t, out_s):
        np.testing.assert_allclose(pt, ps, atol=1e-6)
    for name in ("kf_pose", "kf_valid", "kf_obs", "pt_pos", "pt_valid", "pt_visible",
                 "pt_found", "spanning_parent"):
        assert torch.equal(getattr(s.map, name), getattr(seq.map, name)), name
    assert s.free_pt == seq.free_pt and s.free_kf == seq.free_kf
    assert s.ba_iterations == seq.ba_iterations


def test_drained_async_counters_match_jax(drained_runs):
    """The tracker's visibility deltas, merged by the mapper through the
    forwarding table, give JAX's counters."""
    _, (jsys, s, _) = drained_runs
    live = np.asarray(jsys.map.pt_valid)
    np.testing.assert_array_equal(s.map.pt_visible.numpy()[live],
                                  np.asarray(jsys.map.pt_visible)[live])
    np.testing.assert_array_equal(s.map.pt_found.numpy()[live],
                                  np.asarray(jsys.map.pt_found)[live])


def test_merge_pending_matches_jax():
    """Both `_merge_pending`s on the same deltas, counters and forwarding
    table (merges, a chain, dead ends)."""
    from orb_slam_tpu.pipeline.async_system import AsyncSLAMSystem as JaxAsync
    from orb_slam_tpu.slam_map import MapConfig as JaxMapConfig
    from orb_slam_tpu.slam_map import empty_map as jax_empty_map
    from orb_slam_tpu_torch.slam_map.map_state import empty_map

    P = 64
    rng = np.random.default_rng(3)
    fwd = np.arange(P, dtype=np.int32)
    fwd[[5, 9, 30]] = [9, 17, 5]
    fwd[[4, 11]] = -1
    deltas = [(rng.integers(0, 3, P).astype(np.int32),
               rng.integers(0, 2, P).astype(np.int32)) for _ in range(3)]
    base_v = rng.integers(0, 9, P).astype(np.int32)
    base_f = rng.integers(0, 5, P).astype(np.int32)

    jm = jax_empty_map(JaxMapConfig(max_keyframes=4, max_points=P, n_features=8))
    j = SimpleNamespace(
        _lock=threading.Lock(), pt_forward=fwd.copy(),
        _pending_deltas=[(jnp.asarray(v), jnp.asarray(f)) for v, f in deltas],
        map=jm._replace(pt_visible=jnp.asarray(base_v), pt_found=jnp.asarray(base_f)))
    JaxAsync._merge_pending(j)

    tm = empty_map(MapConfig(max_keyframes=4, max_points=P, n_features=8), "cpu")
    t = SimpleNamespace(
        _lock=threading.Lock(), pt_forward=fwd.copy(), device=torch.device("cpu"),
        _pending_deltas=[(torch.from_numpy(v), torch.from_numpy(f)) for v, f in deltas],
        map=tm.replace(pt_visible=torch.from_numpy(base_v),
                       pt_found=torch.from_numpy(base_f)))
    AsyncSLAMSystem._merge_pending(t)
    assert t._pending_deltas == []
    np.testing.assert_array_equal(t.map.pt_visible.numpy(), np.asarray(j.map.pt_visible))
    np.testing.assert_array_equal(t.map.pt_found.numpy(), np.asarray(j.map.pt_found))
    assert (t.map.pt_visible.numpy() != base_v).any()


def test_tracks_with_background_mapper():
    scene = SyntheticScene(n_points=500, seed=7)
    s = port_async(scene)
    try:
        poses = lateral_trajectory(30, step=0.08)
        tracked = sum(s.process(features=scene.observe(p, n_slots=N_SLOTS)) is not None
                      for p in poses)
        s.finish()
        assert tracked >= 20 and s.state == tsys.WORKING
        assert s.n_keyframes >= 2 and s.n_points > 100
        assert int(s.map.pt_visible.max()) > 3      # deltas merged, not lost
        assert len(s.free_pt) == int((~s.map.pt_valid).sum())
    finally:
        s.close()
    assert not s._thread.is_alive()


def test_stop_release_protocol():
    scene = SyntheticScene(n_points=500, seed=7)
    s = port_async(scene)
    try:
        poses = lateral_trajectory(12, step=0.08)
        for p in poses:
            s.process(features=scene.observe(p, n_slots=N_SLOTS))
        s.finish()
        s.request_stop()
        assert s._stopped.is_set()
        n_before = s.n_keyframes
        # the exclusive window: a keyframe queued now is dropped by release
        s._dispatch_keyframe(s._prev_frame[0], s._prev_frame[1], 50, s.last_pose.copy())
        s.release()
        s.finish()
        assert s.n_keyframes == n_before
        assert s.process(features=scene.observe(poses[-1], n_slots=N_SLOTS)) is not None
        s.finish()
    finally:
        s.close()


def test_reset_in_parked_window_does_not_deadlock():
    """A reset from the tracker while another caller owns the park window
    waits for the release, then rebuilds; a reset under a parked mapper
    with a queued keyframe completes. Each runs in a thread joined with a
    time limit."""
    scene = SyntheticScene(n_points=500, seed=7)
    s = port_async(scene)
    try:
        poses = lateral_trajectory(10, step=0.08)
        for p in poses:
            s.process(features=scene.observe(p, n_slots=N_SLOTS))
        s.finish()
        s.request_stop()
        s._kf_queue.put((s._prev_frame[0], s._prev_frame[1], 50, s.last_pose.copy()))
        done = threading.Event()
        t = threading.Thread(target=lambda: (s.reset(), done.set()), daemon=True)
        t.start()
        t.join(timeout=1.0)
        assert not done.is_set()          # waits for the owner's release
        s.release()
        t.join(timeout=60.0)
        assert done.is_set() and not t.is_alive()
        assert s.state == tsys.NO_IMAGES_YET and s.n_keyframes == 0
        assert s._kf_queue.empty() and not s._stop_requested.is_set()
        t = threading.Thread(target=s.reset, daemon=True)
        t.start()
        t.join(timeout=60.0)
        assert not t.is_alive()
        s.finish(timeout=30.0)
    finally:
        s.close()


def test_mapper_error_raised_by_finish():
    scene = SyntheticScene(n_points=500, seed=7)
    s = port_async(scene)
    try:
        def broken(*a, **k):
            raise ValueError("mapper fault")

        s._integrate_keyframe = broken
        poses = lateral_trajectory(12, step=0.08)
        for p in poses:
            s.process(features=scene.observe(p, n_slots=N_SLOTS))
        with pytest.raises(ValueError, match="mapper fault"):
            s.finish()
    finally:
        s.close()


def test_counter_deltas_under_contention():
    """Eight threads append counter deltas while the caller merges them,
    with a short switch interval: every increment lands exactly once."""
    scene = SyntheticScene(n_points=50, seed=1)
    s = port_async(scene)
    P = s.cfg.map.max_points
    ones = torch.ones(P, dtype=torch.int32)
    res = type("R", (), {"visible_inc": ones, "found_inc": ones})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(50):
                s._apply_counters(res)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for _ in range(20):
            s._merge_pending()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        s._merge_pending()
    finally:
        sys.setswitchinterval(interval)
        s.close()
    assert (s.map.pt_visible == 400).all() and (s.map.pt_found == 400).all()


def test_async_loop_and_reloc_enabled():
    scene = SyntheticScene(n_points=500, seed=13)
    s = port_async(scene, enable_loop_closing=True, enable_relocalisation=True,
                   kf_tracked_ratio=1.2, min_frames_between_kf=2)
    try:
        assert s._loop_thread is not None and s._loop_thread.is_alive()
        poses = lateral_trajectory(24, step=0.08)
        tracked = sum(s.process(features=scene.observe(p, n_slots=N_SLOTS)) is not None
                      for p in poses)
        s.finish()
        assert tracked >= 16 and s.state == tsys.WORKING
        assert s.db is not None and s.db.active.sum() >= 2
    finally:
        s.close()
    assert not s._loop_thread.is_alive()


def test_async_defaults_to_the_card():
    if torch.cuda.is_available():
        s = AsyncSLAMSystem(tsys.SlamConfig())
        try:
            assert s.map.pt_pos.is_cuda
        finally:
            s.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            AsyncSLAMSystem(tsys.SlamConfig())


if __name__ == "__main__":
    import json

    (out_j, out_t, _), (jsys, s, _) = drained()
    slot = s.kf_order.tolist().index(3)
    b = int(s.map.kf_frame_id[slot]) - CARRY_AT
    print(json.dumps(dict(
        keyframe_frame=int(s.map.kf_frame_id[slot]),
        jax_ba_moved_new_keyframe=float(np.abs(np.asarray(jsys.map.kf_pose[slot])
                                               - np.asarray(out_j[b])).max()),
        port_ba_moved_new_keyframe=float(np.abs(s.map.kf_pose[slot].numpy()
                                                - out_t[b]).max()),
        kf_pose_max_diff=float(np.abs(s.map.kf_pose.numpy()
                                      - np.asarray(jsys.map.kf_pose)).max()))))
