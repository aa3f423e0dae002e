"""Relocalisation end to end on the port alone: the blackout-and-revisit
scenario of tests/test_loop_reloc_e2e.py:37-81 with oracle features, and
a blank frame through the extractor on both packages.

The scenario: 18 frames of a straight lateral run build a map of more
than 5 keyframes (a keyframe every few frames, culling off, as the JAX
test configures it), 3 frames without features lose the camera without
the auto-reset, and mapped viewpoints come back. Revisiting frames 6-11,
as the JAX test does, the camera recovers (on this scene through the
tracking ladder, in JAX as in the port) with JAX's bound on the pose.
Revisiting frame 0, 17 frames from the last tracked pose, tracking fails
and the first revisit frame is relocalised against the keyframe database:
`n_relocs` becomes 1, the pose is frame 0's (the map's origin) within
0.01, and the next revisit frames track from it.

A uniform-gray 320x240 frame (the blackout of chip_smoke.py's
relocalisation path, at the tests' size) gives all-invalid features on
both packages, without raising.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.frontend.orb_extractor import ORBConfig as JaxConfig
from orb_slam_tpu.frontend.orb_extractor import ORBExtractor as JaxExtractor
from orb_slam_tpu.frontend.orb_extractor import _extract_stacked
from orb_slam_tpu.io.synthetic import SyntheticScene
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.slam_map.map_state import MapConfig
from tests.test_torch_system_map import _two_threads  # noqa: F401 (autouse)

N_SLOTS = 200


def yaw_pose(yaw, C):
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, -R @ np.asarray(C, np.float32)
    return T


@pytest.fixture(scope="module")
def lost():
    """(the port's system, LOST after the blackout, the scene, the poses)."""
    scene = SyntheticScene(n_points=500, seed=3)
    cfg = tsys.SlamConfig(
        camera=CameraModel(scene.fx, scene.fy, scene.cx, scene.cy,
                           width=scene.width, height=scene.height),
        orb=None, map=MapConfig(max_keyframes=32, max_points=2048, n_features=N_SLOTS),
        p_local=512, n_triangulation_neighbors=3, n_fuse_neighbors=2,
        local_ba_window=6, enable_loop_closing=False, max_frames_between_kf=3,
        kf_tracked_ratio=1.5, kf_cull_redundancy=1.1)
    s = tsys.SLAMSystem(cfg, device="cpu")
    poses = [yaw_pose(0.0, [0.06 * i, 0, 0]) for i in range(25)]
    for T in poses[:18]:
        s.process(features=scene.observe(T, n_slots=N_SLOTS))
    assert s.state == tsys.WORKING and s.n_keyframes > 5
    assert s.db is not None and s.db.active.sum() == s.n_keyframes
    dead = dict(xy=np.zeros((N_SLOTS, 2), np.float32),
                desc=np.zeros((N_SLOTS, 8), np.uint32),
                octave=np.zeros(N_SLOTS, np.int32),
                angle=np.zeros(N_SLOTS, np.float32), valid=np.zeros(N_SLOTS, bool))
    for _ in range(3):
        assert s.process(features=dead) is None
    assert s.state == tsys.LOST and s.lost_count == 3 and s.n_relocs == 0
    assert s.n_keyframes > 5                       # no auto-reset
    return s, scene, poses


def test_recovers_after_blackout(lost):
    """tests/test_loop_reloc_e2e.py:63-81 on the port."""
    s, scene, poses = copy.deepcopy(lost)
    recovered = False
    for i in range(6, 12):
        T = poses[i]
        out = s.process(features=scene.observe(T, n_slots=N_SLOTS))
        if out is not None and s.state == tsys.WORKING:
            recovered = True
            C_est = -out[:3, :3].T @ out[:3, 3]
            C_gt = -T[:3, :3].T @ T[:3, 3]
            assert np.linalg.norm(C_est - C_gt * np.linalg.norm(C_est)
                                  / max(np.linalg.norm(C_gt), 1e-9)) < 0.5
            break
    assert recovered, "failed to recover after blackout"


def test_relocalises_against_the_database(lost):
    s, scene, poses = copy.deepcopy(lost)
    out = s.process(features=scene.observe(poses[0], n_slots=N_SLOTS))
    assert s.n_relocs == 1 and s.state == tsys.WORKING and out is not None
    C_est = -out[:3, :3].T @ out[:3, 3]
    assert np.linalg.norm(C_est) < 0.01, C_est
    assert s.trajectory[-1][0] == s.frame_id - 1
    for i in range(1, 4):
        assert s.process(features=scene.observe(poses[i], n_slots=N_SLOTS)) is not None
    assert s.state == tsys.WORKING and s.n_relocs == 1


def test_blank_frame_gives_no_features():
    H, W = 240, 320
    img = np.full((H, W), 128.0, np.float32)
    jc = JaxConfig(n_features=300, n_levels=4)
    consts = JaxExtractor(jc, use_pallas=False).pyramid_consts((H, W))
    fj = jax.jit(lambda im, c: _extract_stacked(im, c, config=jc, use_pallas=False))(
        jnp.asarray(img), consts)
    ft = ORBExtractor(ORBConfig(n_features=300, n_levels=4), H, W, device="cpu")(
        torch.from_numpy(img))
    assert not np.asarray(fj.valid).any()
    assert not ft.valid.any() and ft.valid.shape == (300,)
    assert torch.isfinite(ft.xy).all() and torch.isfinite(ft.angle).all()
