"""The port's main path as a whole against the JAX package, and the
boundaries of the port: no JAX import, no run without a CUDA device.

`extract_track_chunk` runs 3 rendered 320x240 frames (300 features, 4
levels) against a 1024-slot map; the JAX reference is bench.py:98-108's
scan of `_extract_stacked` -> `undistort_points` ->
`chunk_track_step(retry=False)` on the same map, built with
orb_slam_tpu.slam_map and carried over by orb_slam_tpu_torch.convert.

Tolerances and why: level-0 keypoints and all descriptors are exact (see
test_torch_extractor.py), at least 98% of all keypoints are identical;
poses agree to 1e-3 (the f32 Gauss-Newton sums run in another order, and
a rare differing upper-level keypoint changes a match), inlier and match
counts within 2% of the feature count, and the port tracks the
ground-truth camera centres (1 cm steps) to 2 cm: the map is back-projected
from one frame's keypoints onto flat billboards, so it is only that good.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.frontend.orb_extractor import ORBConfig as JaxConfig
from orb_slam_tpu.frontend.orb_extractor import ORBExtractor as JaxExtractor
from orb_slam_tpu.frontend.orb_extractor import _extract_stacked
from orb_slam_tpu.geometry.camera import CameraModel as JaxCamera
from orb_slam_tpu.geometry.camera import undistort_points as jax_undistort
from orb_slam_tpu.geometry.camera import undistorted_bounds as jax_bounds
from orb_slam_tpu.io import synthetic as jsyn
from orb_slam_tpu.pipeline.track_kernels import chunk_track_step
from orb_slam_tpu.slam_map.map_state import MapConfig as JaxMapConfig
from orb_slam_tpu.slam_map.map_state import add_points, empty_map
from orb_slam_tpu_torch.convert import (
    camera_from_numpy, map_state_from_numpy, orb_config_from_dict,
)
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.geometry.camera import undistort_points, undistorted_bounds
from orb_slam_tpu_torch.io import synthetic as tsyn
from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
from orb_slam_tpu_torch.slam_map.map_state import MapConfig

REPO = Path(__file__).resolve().parents[1]
W, H, NF, L, P, B = 320, 240, 300, 4, 1024, 3
DIST = {"pinhole": (0.0, 0.0, 0.0, 0.0), "distorted": (-0.05, 0.01, 1e-3, -1e-3)}


def scenes(dist):
    kw = dict(n_points=400, width=W, height=H, fx=250.0, fy=250.0, cx=160.0,
              cy=120.0, dist=dist)
    return jsyn.SyntheticScene(**kw), tsyn.SyntheticScene(**kw)


def build_maps(tscene, pose0, extractor):
    """The port's seed_map from frame 0, rebuilt with orb_slam_tpu.slam_map
    and carried back through convert: both packages track one state."""
    img0 = torch.from_numpy(tscene.render_image(pose0))
    f = extractor(img0)
    seeded = tsyn.seed_map(tscene, pose0, f.xy, f.desc_i32, f.octave, f.valid,
                           MapConfig(max_keyframes=8, max_points=P,
                                     n_features=NF, n_levels=L), device="cpu",
                           n_extra=500)
    n = int(seeded.pt_valid.sum())
    m = empty_map(JaxMapConfig(max_keyframes=8, max_points=P, n_features=NF,
                               n_levels=L))
    m = add_points(m, jnp.arange(n), jnp.asarray(seeded.pt_pos[:n].numpy()),
                   jnp.asarray(seeded.pt_desc[:n].numpy().view(np.uint32)),
                   jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
                   jnp.ones(n, bool))
    m = m._replace(pt_max_dist=jnp.asarray(seeded.pt_max_dist.numpy()),
                   pt_min_dist=jnp.asarray(seeded.pt_min_dist.numpy()),
                   pt_normal=jnp.asarray(seeded.pt_normal.numpy()))
    return m, map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()},
                                   device="cpu")


def jax_chunk(imgs, m, cam, K, pose0, score_harris=False):
    cfg = JaxConfig(n_features=NF, n_levels=L, score_harris=score_harris)
    consts = JaxExtractor(cfg, use_pallas=False).pyramid_consts((H, W))

    def fn(imgs, consts, state, pose0, vel0):
        def one(carry, img):
            f = _extract_stacked(img, consts, config=cfg, use_pallas=False)
            xy = jax_undistort(cam, f.xy)
            carry, out = chunk_track_step(
                state, xy, f.desc_u32, f.octave, f.valid, carry, K,
                p_local=P, width=W, height=H, radius=15.0, max_dist=100,
                min_inliers=30, use_motion_model=True, retry=False,
                scale_factor=1.2, n_levels=L)
            return carry, (f, xy, out)
        return jax.lax.scan(one, (pose0, vel0), imgs)[1]

    return jax.jit(fn)(jnp.asarray(imgs), consts, m, jnp.asarray(pose0), jnp.eye(4))


@pytest.mark.parametrize("kind", ["pinhole", "distorted"])
def test_extract_track_chunk_matches_jax(kind):
    jscene, tscene = scenes(DIST[kind])
    poses = tsyn.lateral_trajectory(B + 1, step=0.01)
    jcam, cam = jscene.camera_model(), tscene.camera_model()
    extractor = ORBExtractor(ORBConfig(n_features=NF, n_levels=L), H, W, device="cpu")
    m, state = build_maps(tscene, poses[0], extractor)
    imgs = np.stack([tscene.render_image(p) for p in poses[1:]])

    fj, xyj, (pj, obsj, nij, nmj, visj) = jax_chunk(
        imgs, m, jcam, jnp.asarray(jscene.K), poses[0])
    ft, xyt, ct = extract_track_chunk(
        torch.from_numpy(imgs), extractor, cam, state,
        torch.from_numpy(poses[0]), torch.eye(4), torch.from_numpy(tscene.K),
        p_local=P, radius=15.0, min_inliers=30, use_motion_model=True,
        max_dist=100)

    check_chunk(fj, xyj, pj, nij, nmj, visj, ft, xyt, ct, poses)


def check_chunk(fj, xyj, pj, nij, nmj, visj, ft, xyt, ct, poses):
    """The port's chunk (ft, xyt, ct) against the JAX scan's outputs, with
    the tolerances of the module docstring."""
    octave = np.asarray(fj.octave)
    l0 = octave == 0
    np.testing.assert_array_equal(ft.xy.numpy()[l0], np.asarray(fj.xy)[l0])
    np.testing.assert_array_equal(ft.desc_i32.numpy()[l0],
                                  np.asarray(fj.desc_u32).view(np.int32)[l0])
    same = np.all(ft.xy.numpy() == np.asarray(fj.xy), -1).mean()
    assert same >= 0.98, same
    np.testing.assert_allclose(xyt.numpy(), np.asarray(xyj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ct.pose.numpy(), np.asarray(pj), atol=1e-3)
    assert np.abs(ct.n_inliers.numpy() - np.asarray(nij)).max() <= 0.02 * NF
    assert np.abs(ct.n_matches.numpy() - np.asarray(nmj)).max() <= 0.02 * NF
    assert np.mean(ct.visible.numpy() != np.asarray(visj)) <= 0.005
    assert int(ct.n_inliers.min()) >= 30
    center = lambda T: -np.einsum("bji,bj->bi", T[:, :3, :3], T[:, :3, 3])
    err = np.linalg.norm(center(ct.pose.numpy()) - center(poses[1:]), axis=1)
    assert err.max() < 0.02, err


def test_port_never_imports_jax():
    """Every module of the port and chip_smoke.py import with JAX blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import orb_slam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.startswith('orb_slam_tpu.') or m == 'orb_slam_tpu']\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_cuda(tmp_path, alone):
    """No CUDA device: a non-zero exit, no result line, nothing built. The
    same from a directory holding chip_smoke.py alone."""
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "build:" not in out.stdout


def test_convert_roundtrip():
    jm = empty_map(JaxMapConfig(max_keyframes=4, max_points=32, n_features=16))
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 2 ** 32, (32, 8), dtype=np.uint32)
    jm = add_points(jm, jnp.arange(32), jnp.asarray(rng.normal(size=(32, 3)), jnp.float32),
                    jnp.asarray(desc), jnp.zeros(32, jnp.int32),
                    jnp.zeros(32, jnp.int32), jnp.asarray(rng.random(32) > 0.3))
    st = map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()},
                              device="cpu")
    for k, v in jm._asdict().items():
        got = getattr(st, k).numpy()
        want = np.asarray(v)
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want)
    cam = camera_from_numpy(JaxCamera.create(500, 501, 320, 240, k1=-0.1,
                                             width=640, height=480)._asdict())
    assert (cam.fx, cam.fy, cam.width, cam.height) == (500.0, 501.0, 640, 480)
    assert cam.k1 == float(np.float32(-0.1))
    cfg = orb_config_from_dict(dataclasses.asdict(JaxConfig(n_features=500)))
    assert cfg == ORBConfig(n_features=500)


@pytest.mark.parametrize("kind", ["pinhole", "distorted"])
def test_undistort_matches_jax(kind):
    jscene, tscene = scenes(DIST[kind])
    jcam, cam = jscene.camera_model(), tscene.camera_model()
    uv = np.random.default_rng(1).uniform([0, 0], [W, H], (200, 2)).astype(np.float32)
    np.testing.assert_allclose(undistort_points(cam, torch.from_numpy(uv)).numpy(),
                               np.asarray(jax_undistort(jcam, jnp.asarray(uv))),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(undistorted_bounds(cam),
                               [float(v) for v in jax_bounds(jcam)], atol=1e-3)


@pytest.mark.parametrize("quantize", [False, True])
def test_synthetic_scene_matches_jax(quantize):
    jscene, tscene = scenes(DIST["distorted"])
    np.testing.assert_array_equal(tscene.points, jscene.points)
    np.testing.assert_array_equal(tscene.descriptors, jscene.descriptors)
    np.testing.assert_array_equal(tscene.K, jscene.K)
    poses = tsyn.lateral_trajectory(6, step=0.05, yaw_rate=0.01)
    np.testing.assert_allclose(poses, jsyn.lateral_trajectory(6, step=0.05,
                                                              yaw_rate=0.01),
                               atol=1e-7)
    kw = dict(quantize=quantize, noise=2.0, vignette=0.2, exposure=1.1)
    np.testing.assert_array_equal(tscene.render_image(poses[3], **kw),
                                  jscene.render_image(poses[3], **kw))


def test_seed_map_back_projects_keypoints():
    _, tscene = scenes(DIST["pinhole"])
    pose0 = tsyn.lateral_trajectory(1)[0]
    f = ORBExtractor(ORBConfig(n_features=NF, n_levels=L), H, W, device="cpu")(
        torch.from_numpy(tscene.render_image(pose0)))
    st = tsyn.seed_map(tscene, pose0, f.xy, f.desc_i32, f.octave, f.valid,
                       MapConfig(max_points=P, n_features=NF, n_levels=L),
                       device="cpu", n_extra=100)
    z = tscene.billboard_depth(pose0, f.xy.numpy())
    keep = f.valid.numpy() & np.isfinite(z)
    n = int(keep.sum())
    assert n > 0.5 * NF and int(st.pt_valid.sum()) == n + 100
    pc = st.pt_pos[:n].numpy() @ pose0[:3, :3].T + pose0[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * 250.0 + [160.0, 120.0]
    np.testing.assert_allclose(uv, f.xy.numpy()[keep], atol=1e-3)
    np.testing.assert_array_equal(st.pt_desc[:n].numpy(), f.desc_i32.numpy()[keep])


def test_kernels_raise_without_nvcc(tmp_path, monkeypatch):
    """No toolkit: building any kernel raises, and nothing is counted."""
    from orb_slam_tpu_torch import _build
    from orb_slam_tpu_torch.ops.fast_cell_topk import KERNEL as K4
    from orb_slam_tpu_torch.ops.fast_score_nms import KERNEL as K1
    from orb_slam_tpu_torch.ops.fast_score_rect import KERNEL as K3
    from orb_slam_tpu_torch.solvers.pose_opt import KERNEL as K2

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_libraries([k.source for k in (K1, K2, K3, K4)])
    for kernel in (K1, K2, K3, K4):
        before = kernel.launches
        with pytest.raises(RuntimeError, match="nvcc"):
            kernel.load()
        assert kernel.launches == before


def _default_builds():
    """Each entry point of the port that builds tensors, called with its
    default device; returns a tensor it built."""
    from orb_slam_tpu_torch.ops.fast_stack import DetectCellsFused, KeypointSelector
    from orb_slam_tpu_torch.slam_map.map_state import empty_map as t_empty_map

    shapes, quotas = [(240, 320), (200, 267)], [60, 40]
    cfg = MapConfig(max_keyframes=2, max_points=8, n_features=4, n_levels=2)
    jm = empty_map(JaxMapConfig(max_keyframes=2, max_points=8, n_features=4))
    _, tscene = scenes(DIST["pinhole"])
    xy = np.full((4, 2), 100.0, np.float32)
    z4 = np.zeros((4, 8), np.int32)
    return {
        "ORBExtractor": lambda: ORBExtractor(ORBConfig(n_features=60, n_levels=2),
                                             H, W).wx,
        "ORBExtractor_per_level": lambda: ORBExtractor(
            ORBConfig(n_features=60, n_levels=2), H, W, stacked=False).pat,
        "KeypointSelector": lambda: KeypointSelector(shapes, quotas).quota_t,
        "DetectCellsFused": lambda: DetectCellsFused(shapes, quotas).gather,
        "empty_map": lambda: t_empty_map(cfg).pt_pos,
        "map_state_from_numpy": lambda: map_state_from_numpy(
            {k: np.asarray(v) for k, v in jm._asdict().items()}).pt_pos,
        "seed_map": lambda: tsyn.seed_map(
            tscene, tsyn.lateral_trajectory(1)[0], xy, z4, np.zeros(4, np.int32),
            np.ones(4, bool), cfg, n_extra=2).pt_pos,
    }


@pytest.mark.parametrize("entry", [
    "ORBExtractor", "ORBExtractor_per_level", "KeypointSelector",
    "DetectCellsFused", "empty_map", "map_state_from_numpy", "seed_map"])
def test_entry_points_default_to_the_card(entry):
    """Without device=, an entry point builds on the CUDA card; with no card
    it raises and never lands on the CPU."""
    build = _default_builds()[entry]
    if torch.cuda.is_available():
        assert build().is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
