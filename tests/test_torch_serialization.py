"""Sessions (slam_map/serialization.py) between the port and the JAX
package, which share one file format.

A JAX SLAMSystem in oracle-features mode, with loop closing and
relocalisation on (so the session carries the shipped vocabulary, the
keyframe database and the loop closer's state), runs 16 frames of
tests/test_async_loop.py's scene. Its session loads into the port with
every array equal (descriptors bit-equal as the int32 view of JAX's
uint32 words) and the port keeps tracking; the port then writes its own
session, which loads into JAX with every array equal and JAX keeps
tracking; and the port's own round trip restores its generators.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from orb_slam_tpu.geometry import CameraModel as JaxCamera
from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.pipeline.system import SLAMSystem as JaxSystem
from orb_slam_tpu.pipeline.system import SlamConfig as JaxConfig
from orb_slam_tpu.slam_map import MapConfig as JaxMapConfig
from orb_slam_tpu.slam_map import serialization as jser
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.slam_map import serialization as tser
from orb_slam_tpu_torch.slam_map.map_state import MapConfig, MapState

N_SLOTS = 200
N_FRAMES = 16
OPTIONS = dict(p_local=512, n_triangulation_neighbors=3, n_fuse_neighbors=2,
               local_ba_window=6, kf_tracked_ratio=1.2, min_frames_between_kf=2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for torch while this module runs (as
    tests/test_torch_system_map.py: several test processes share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_system(scene):
    cfg = JaxConfig(
        camera=JaxCamera.create(scene.fx, scene.fy, scene.cx, scene.cy,
                                width=scene.width, height=scene.height),
        map=JaxMapConfig(max_keyframes=32, max_points=2048, n_features=N_SLOTS),
        **OPTIONS)
    cfg.orb = None
    return JaxSystem(cfg)


def port_system(scene):
    cfg = tsys.SlamConfig(
        camera=CameraModel(scene.fx, scene.fy, scene.cx, scene.cy,
                           width=scene.width, height=scene.height),
        orb=None, map=MapConfig(max_keyframes=32, max_points=2048,
                                n_features=N_SLOTS), **OPTIONS)
    return tsys.SLAMSystem(cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_session(tmp_path_factory):
    """(the JAX system after N_FRAMES frames, its session file, the scene,
    the poses)."""
    scene = SyntheticScene(n_points=500, seed=13)
    poses = lateral_trajectory(N_FRAMES + 2, step=0.08)
    s = jax_system(scene)
    for p in poses[:N_FRAMES]:
        s.process(features=scene.observe(p, n_slots=N_SLOTS))
    assert s.state == tsys.WORKING and s.db is not None and s.loop_closer is not None
    path = str(tmp_path_factory.mktemp("jax") / "session.npz")
    jser.save_session(path, s)
    return s, path, scene, poses


def assert_map_equal(jax_map, port_map):
    for f in dataclasses.fields(MapState):
        a, b = np.asarray(getattr(jax_map, f.name)), getattr(port_map, f.name).numpy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f.name)


def test_jax_session_loads_into_the_port(jax_session):
    js, path, scene, poses = jax_session
    t = tser.load_session(path, port_system(scene))
    assert_map_equal(js.map, t.map)
    np.testing.assert_array_equal(t.vocab.node_desc,
                                  np.asarray(js.vocab.node_desc).view(np.int32))
    for f in ("children", "is_leaf", "word_of_node", "node_of_word", "word_weight",
              "level_of_node"):
        np.testing.assert_array_equal(getattr(t.vocab, f), getattr(js.vocab, f), err_msg=f)
    assert (t.vocab.k, t.vocab.L) == (js.vocab.k, js.vocab.L)
    np.testing.assert_array_equal(t.db.bow_ids.numpy(), np.asarray(js.db.bow_ids))
    np.testing.assert_array_equal(t.db.bow_w.numpy(), np.asarray(js.db.bow_w))
    np.testing.assert_array_equal(t.db.active, js.db.active)
    assert t.loop_closer is not None and t.loop_closer.db is t.db
    assert t.loop_closer.last_loop_kf_counter == js.loop_closer.last_loop_kf_counter
    assert t.loop_closer.consistent_groups == js.loop_closer.consistent_groups
    assert t.free_kf == js.free_kf and t.free_pt == js.free_pt
    np.testing.assert_array_equal(t.kf_order, js.kf_order)
    assert (t.kf_counter, t.frame_id, t.state, t.last_kf_slot, t.last_kf_frame,
            t.ref_kf_tracked) == (js.kf_counter, js.frame_id, js.state, js.last_kf_slot,
                                  js.last_kf_frame, js.ref_kf_tracked)
    np.testing.assert_array_equal(t.last_pose, np.asarray(js.last_pose))
    assert len(t.trajectory) == len(js.trajectory)
    # JAX's rng_key is not read: the generator keeps its seeding
    assert torch.equal(t._gen.get_state(),
                       torch.Generator().manual_seed(t.cfg.seed).get_state())
    for p in poses[N_FRAMES:]:
        assert t.process(features=scene.observe(p, n_slots=N_SLOTS)) is not None


def test_port_session_loads_into_jax(jax_session, tmp_path):
    js, path, scene, poses = jax_session
    t = tser.load_session(path, port_system(scene))
    t.process(features=scene.observe(poses[N_FRAMES], n_slots=N_SLOTS))
    out = str(tmp_path / "port_session.npz")
    tser.save_session(out, t)
    j2 = jser.load_session(out, jax_system(scene))
    assert_map_equal(j2.map, t.map)
    np.testing.assert_array_equal(np.asarray(j2.vocab.node_desc).view(np.int32),
                                  t.vocab.node_desc)
    np.testing.assert_array_equal(np.asarray(j2.db.bow_ids), t.db.bow_ids.numpy())
    np.testing.assert_array_equal(j2.db.active, t.db.active)
    assert j2.free_pt == t.free_pt and j2.kf_counter == t.kf_counter
    assert j2.process(features=scene.observe(poses[N_FRAMES + 1], n_slots=N_SLOTS)) \
        is not None


def test_port_round_trip(jax_session, tmp_path):
    """The port's own session: equal arrays and host state, the generators'
    states restored, and tracking goes on."""
    js, path, scene, poses = jax_session
    t = tser.load_session(path, port_system(scene))
    torch.randint(0, 10, (5,), generator=t._gen)           # move the generators
    torch.randint(0, 10, (3,), generator=t.loop_closer._gen)
    out = str(tmp_path / "round.npz")
    tser.save_session(out, t)
    t2 = tser.load_session(out, port_system(scene))
    for f in dataclasses.fields(MapState):
        assert torch.equal(getattr(t.map, f.name), getattr(t2.map, f.name)), f.name
    assert torch.equal(t2._gen.get_state(), t._gen.get_state())
    assert torch.equal(t2.loop_closer._gen.get_state(), t.loop_closer._gen.get_state())
    assert t2.free_pt == t.free_pt and t2.trajectory[-1][0] == t.trajectory[-1][0]
    np.testing.assert_array_equal(t2.trajectory[-1][2], t.trajectory[-1][2])
    assert t2.process(features=scene.observe(poses[N_FRAMES], n_slots=N_SLOTS)) \
        is not None


def test_save_map_load_map(jax_session, tmp_path):
    js, path, scene, _ = jax_session
    t = tser.load_session(path, port_system(scene))
    out = str(tmp_path / "map.npz")
    tser.save_map(out, t.map, extra={"note": "x"})
    m, extra = tser.load_map(out, device="cpu")
    assert extra == {"note": "x"}
    for f in dataclasses.fields(MapState):
        assert torch.equal(getattr(m, f.name), getattr(t.map, f.name)), f.name
    jm, jextra = jser.load_map(out)
    assert_map_equal(jm, m)
    assert os.path.getsize(out) > 0


def test_load_map_defaults_to_the_card(jax_session):
    _, path, _, _ = jax_session
    if torch.cuda.is_available():
        assert tser.load_map(path)[0].pt_pos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tser.load_map(path)
