"""The port's SLAMSystem against the JAX package's: one whole keyframe
integration from a live JAX system, and the port's tracking-and-mapping
path on rendered frames.

`_integrate_keyframe`: the JAX system of tests/test_system_vo.py after 12
oracle-feature frames, frame 12 tracked by JAX's track_frame, then one
integration (insertion, covisibility, culling, triangulation, fuse, point
statistics, two-phase local BA, keyframe culling) on a JAX copy and on the
port's SLAMSystem built from the same state through convert.py, as
tests/test_parallel.py:168-222 compares its mesh and single-device runs.
Loop closing is off in the JAX copy: the port has no place recognition
yet. Tolerances and why: the host lists (free points, keyframe order,
forwarding table) equal; poses within 1e-4 and the points seen by at least
3 keyframes within 1e-3 (f32 normal equations summed in another order,
through LAPACK instead of XLA); at most 2 points' validity and under 0.5%
of kf_obs differing (a float near a gate can flip one decision), the
bounds test_parallel.py holds the mesh run to. A point seen by one or two
keyframes has its depth fixed only by one pair's small parallax (>= 1.1
degrees), and the LM stops at a relative gain of 1e-4 before converging
along it, so a reordered f32 sum moves it along its ray. Measured: 1.18e-2
for the 12 points seen by two keyframes, 2.9e-3 for the 2 seen by one,
5.0e-4 for the 213 others (poses 2.5e-5, no validity flip, 0.06% of kf_obs
differing); the weakly seen points are held to 1.5e-2.

`process_batch`: 320x240 frames, 300 features, 4 levels, a map seeded
with two keyframes by io/synthetic.py::seed_keyframe_map; the port alone,
since the JAX system cannot start from a seeded map: it must insert
keyframes, triangulate points, run BA, and keep every tracked camera
centre within 5 cm of the ground truth.
"""

import copy
from dataclasses import replace as dc_replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene as JaxScene
from orb_slam_tpu.io.synthetic import lateral_trajectory as jax_trajectory
from orb_slam_tpu.pipeline.track_kernels import track_frame
from orb_slam_tpu.slam_map.observations import observation_table
from orb_slam_tpu_torch.convert import camera_from_numpy, map_state_from_numpy
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.profile_paths import start_working
from orb_slam_tpu_torch.slam_map.map_state import MapConfig
from tests.test_system_vo import run_sequence


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for torch while this module runs. The system runs
    hundreds of small ops per frame; with torch's default of one thread
    per core, several test processes on one host make those threads wait
    on each other, and the float sums' order follows the host's core
    count. Two threads keep the run short and its sums in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_system(jsys):
    """The port's SLAMSystem holding a copy of the JAX system's state."""
    jc = jsys.cfg
    cfg = tsys.SlamConfig(
        camera=camera_from_numpy(jc.camera._asdict()), orb=None,
        map=MapConfig(max_keyframes=jc.map.max_keyframes,
                      max_points=jc.map.max_points,
                      n_features=jc.map.n_features, n_levels=jc.map.n_levels,
                      scale_factor=jc.map.scale_factor),
        p_local=jc.p_local, n_triangulation_neighbors=jc.n_triangulation_neighbors,
        n_fuse_neighbors=jc.n_fuse_neighbors, local_ba_window=jc.local_ba_window)
    s = tsys.SLAMSystem(cfg, device="cpu")
    s.map = map_state_from_numpy({k: np.asarray(v) for k, v in jsys.map._asdict().items()},
                                 device="cpu")
    for name in ("state", "kf_counter", "frame_id", "last_kf_frame", "last_kf_slot",
                 "ref_kf_tracked"):
        setattr(s, name, getattr(jsys, name))
    s.free_kf, s.free_pt = list(jsys.free_kf), list(jsys.free_pt)
    s.kf_order = jsys.kf_order.copy()
    s.pt_forward = jsys.pt_forward.copy()
    s.last_pose = np.array(jsys.last_pose)
    s.velocity = np.array(jsys.velocity)
    s.local_mask = (None if jsys.local_mask is None
                    else torch.from_numpy(np.array(jsys.local_mask)))
    return s


@pytest.fixture(scope="module")
def integrated():
    return integrate_both()


def integrate_both():
    """(the JAX copy, the port's system), each after one _integrate_keyframe
    of frame 12 from the JAX system's state."""
    jsys, _, _ = run_sequence(n_frames=12)
    scene = JaxScene(n_points=500, seed=0)
    feats = scene.observe(jax_trajectory(14, step=0.08)[12], n_slots=200)
    frame = jsys.make_frame(features=feats)
    res = track_frame(jsys.map, frame.xy, frame.desc, frame.octave, frame.valid,
                      jnp.asarray(jsys.last_pose), jsys.K_dev, p_local=jsys.cfg.p_local,
                      width=jsys.cfg.camera.width, height=jsys.cfg.camera.height)
    n_in = int(res.n_inliers)
    assert n_in >= 30
    pose = np.asarray(res.pose)

    tsy = port_system(jsys)
    a = copy.copy(jsys)
    a.cfg = dc_replace(jsys.cfg, enable_loop_closing=False)
    a.free_kf, a.free_pt = list(jsys.free_kf), list(jsys.free_pt)
    a.kf_order = jsys.kf_order.copy()
    a.pt_forward = jsys.pt_forward.copy()
    a.trajectory = list(jsys.trajectory)
    slot_a = a._integrate_keyframe(frame, res.obs, n_in, pose=pose)

    tframe = tsys.FrameData(*(torch.from_numpy(np.array(v)) for v in (
        frame.xy, np.asarray(frame.desc).view(np.int32), frame.octave, frame.angle,
        frame.valid)), frame.frame_id, frame.timestamp)
    slot_t = tsy._integrate_keyframe(tframe, torch.from_numpy(np.array(res.obs)),
                                     n_in, pose=pose)
    assert slot_a == slot_t
    return a, tsy


def test_integrate_keyframe_host_lists(integrated):
    a, t = integrated
    assert a.kf_counter == t.kf_counter and a.last_kf_slot == t.last_kf_slot
    assert a.free_pt == t.free_pt and a.free_kf == t.free_kf
    np.testing.assert_array_equal(a.kf_order, t.kf_order)
    np.testing.assert_array_equal(a.pt_forward, t.pt_forward)
    np.testing.assert_allclose(t.last_pose, a.last_pose, atol=1e-4)
    assert len(t.ba_iterations) == 2


def test_integrate_keyframe_map(integrated):
    a, t = integrated
    np.testing.assert_allclose(t.map.kf_pose.numpy(), np.asarray(a.map.kf_pose), atol=1e-4)
    pv_a, pv_t = np.asarray(a.map.pt_valid), t.map.pt_valid.numpy()
    n_obs = np.asarray(observation_table(a.map)[2]).sum(1)
    d = np.abs(t.map.pt_pos.numpy() - np.asarray(a.map.pt_pos)).max(1)
    assert d[pv_a & (n_obs >= 3)].max() < 1e-3
    assert d[pv_a].max() < 1.5e-2
    assert (pv_a != pv_t).sum() <= 2
    assert (np.asarray(a.map.kf_obs) != t.map.kf_obs.numpy()).mean() < 0.005
    np.testing.assert_array_equal(t.map.kf_valid.numpy(), np.asarray(a.map.kf_valid))
    np.testing.assert_array_equal(t.map.spanning_parent.numpy(),
                                  np.asarray(a.map.spanning_parent))
    np.testing.assert_array_equal(t.local_mask.numpy(), np.asarray(a.local_mask))


def test_process_batch_tracks_and_maps():
    W, H, f = 320, 240, 250.0
    scene = SyntheticScene(n_points=800, width=W, height=H, fx=f, fy=f, cx=W / 2,
                           cy=H / 2)
    poses = lateral_trajectory(12, step=0.04)
    imgs = [scene.render_image(p) for p in poses]
    cfg = tsys.SlamConfig(camera=CameraModel(f, f, W / 2, H / 2, width=W, height=H),
                          orb=ORBConfig(n_features=300, n_levels=4),
                          map=MapConfig(max_keyframes=16, max_points=2048,
                                        n_features=300, n_levels=4))
    s = tsys.SLAMSystem(cfg, device="cpu")
    n_seed = start_working(s, scene, poses, torch.from_numpy(np.stack(imgs)))
    out = s.process_batch(imgs[2:])
    assert len(out) == 10 and s.state == tsys.WORKING
    assert s.kf_counter >= 4                     # keyframes inserted
    assert int(s.map.pt_first_kf[s.map.pt_valid].max()) >= 2   # triangulated
    assert len(s.ba_iterations) == 2 * (s.kf_counter - 2)
    center = lambda T: -T[:3, :3].T @ T[:3, 3]
    err = [np.linalg.norm(center(p) - center(g)) for p, g in zip(out, poses[2:])]
    assert max(err) < 0.05, err
    kv = s.map.kf_valid.numpy()
    fid = s.map.kf_frame_id.numpy()
    for k in np.where(kv)[0]:
        c = center(s.map.kf_pose[k].numpy())
        assert np.linalg.norm(c - center(poses[fid[k]])) < 0.05
    assert np.isfinite(s.map.pt_pos.numpy()).all() and s.n_points > n_seed // 2
    assert len(s.free_pt) == int((~s.map.pt_valid).sum())


def test_unported_states_raise():
    """Formerly: a system not yet WORKING raised NotImplementedError. With
    the initialisation ported the same call runs: a blank frame has no
    keypoints, so the system stays before initialisation, and raises
    nothing."""
    s = tsys.SLAMSystem(tsys.SlamConfig(orb=ORBConfig(n_features=100, n_levels=2),
                                        camera=CameraModel(100.0, 100.0, 64.0, 48.0,
                                                           width=128, height=96)),
                        device="cpu")
    out = s.process_batch([np.zeros((96, 128), np.float32)] * 2)
    assert out == [None, None] and s.state == tsys.NO_IMAGES_YET
    assert s.frame_id == 2 and s.n_keyframes == 0


def test_system_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tsys.SLAMSystem(tsys.SlamConfig()).map.pt_pos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tsys.SLAMSystem(tsys.SlamConfig())
