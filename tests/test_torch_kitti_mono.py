"""ORB-SLAM2's monocular KITTI deployment on the port
(Examples/Monocular/KITTI00-02.yaml, the benchmark's `kitti-mono`).

The published file, typed in below with its comments and `Viewer.*` keys,
goes through the port's settings reader and the CLI's frame-size rule to
a 1241x376 camera and a 2000-feature extractor with ORB-SLAM2's two FAST
thresholds; the benchmark's configuration file gives the program the same
camera and extractor; ORB-SLAM's own Data/Settings.yaml (ORB-SLAM1's
schema) gives what it gave before ORB-SLAM2's keys were read, as JAX's
loader reads it; a file whose two initial thresholds disagree raises. The
port's extractor equals the benchmark's plain reference bit for bit on a
full-size street frame. Then the tracking counters on a short
`process_batch` of the benchmark's drive cut to the CPU (tiny.py), from
its two seeded keyframes: one `track.frames` and one `track.inliers` per
tracked frame, the inliers the host read, and the reader of
`track.inliers_per_frame` over them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam_tpu.io import settings as jset
from orb_slam_tpu_torch.cli import settings_for_images
from orb_slam_tpu_torch.convert import camera_from_numpy, orb_config_from_dict
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.io import settings as tset
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.utils.timing import StageTimer
from slam_bench import check, harness
from slam_bench.reference.orb import Extractor
from slam_bench.scene import TRAJECTORIES
from slam_bench.tests import tiny

CELL = "kitti-mono.drive-batch"

# raulmur/ORB_SLAM2, Examples/Monocular/KITTI00-02.yaml
KITTI00_02 = """\
%YAML:1.0

#--------------------------------------------------------------------------------------------
# Camera Parameters. Adjust them!
#--------------------------------------------------------------------------------------------

# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157

Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0

# Camera frames per second
Camera.fps: 10.0

# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1

#--------------------------------------------------------------------------------------------
# ORB Parameters
#--------------------------------------------------------------------------------------------

# ORB Extractor: Number of features per image
ORBextractor.nFeatures: 2000

# ORB Extractor: Scale factor between levels in the scale pyramid
ORBextractor.scaleFactor: 1.2

# ORB Extractor: Number of levels in the scale pyramid
ORBextractor.nLevels: 8

# ORB Extractor: Fast threshold
# Image is divided in a grid. At each cell FAST are extracted imposing a minimum response.
# Firstly we impose iniThFAST. If no corners are detected we impose a lower value minThFAST
# You can lower these values if your images have low contrast
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

#--------------------------------------------------------------------------------------------
# Viewer Parameters
#--------------------------------------------------------------------------------------------
Viewer.KeyFrameSize: 0.1
Viewer.KeyFrameLineWidth: 1
Viewer.GraphLineWidth: 1
Viewer.PointSize:2
Viewer.CameraSize: 0.15
Viewer.CameraLineWidth: 2
Viewer.ViewpointX: 0
Viewer.ViewpointY: -10
Viewer.ViewpointZ: -0.1
Viewer.ViewpointF: 2000
"""

# raulmur/ORB_SLAM, Data/Settings.yaml: ORB-SLAM1's schema
ORB_SLAM1_SETTINGS = """\
%YAML:1.0

# Camera Parameters. Adjust them!

# Camera calibration parameters (OpenCV)
Camera.fx: 609.2855
Camera.fy: 609.3422
Camera.cx: 351.4274
Camera.cy: 237.7324

# Camera distortion paremeters (OpenCV) --
Camera.k1: -0.3492
Camera.k2: 0.1363
Camera.p1: 0.0
Camera.p2: 0.0

# Camera frames per second
Camera.fps: 30.0

# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1

# ORB Parameters

# Number of features per image
ORBextractor.nFeatures: 1000

# Scale factor between levels in the scale pyramid
ORBextractor.scaleFactor: 1.2

# Number of levels in the scale pyramid
ORBextractor.nLevels: 8

# Fast threshold (lower less restrictive)
ORBextractor.fastTh: 20

# Score to sort features. 0 -> Harris Score, 1 -> FAST Score
ORBextractor.nScoreType: 1

# Constant Velocity Motion Model (0 - disabled, 1 - enabled [recommended])
UseMotionModel: 1
"""

KITTI_CAMERA = CameraModel.create(718.856, 718.856, 607.1928, 185.2157,
                                  width=1241, height=376)
KITTI_ORB = ORBConfig(n_features=2000, n_levels=8, scale_factor=1.2,
                      fast_th_ini=20.0, fast_th_min=7.0)


def write(tmp_path, text, name="settings.yaml"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_the_published_kitti_file_configures_a_1241x376_2000_feature_camera(tmp_path):
    path = write(tmp_path, KITTI00_02)
    cam, orb, extras = settings_for_images(path, np.zeros((376, 1241), np.float32))
    assert cam == KITTI_CAMERA
    assert orb == KITTI_ORB
    assert extras == {"fps": 10.0, "rgb": True, "use_motion_model": True,
                      "score_type": 1}
    # a colour image gives its size the same way; the file's own size wins
    assert settings_for_images(path, np.zeros((376, 1241, 3), np.uint8))[0] == cam
    sized = write(tmp_path, KITTI00_02 + "Camera.width: 1226\nCamera.height: 370\n",
                  "sized.yaml")
    cam2 = settings_for_images(sized, np.zeros((376, 1241), np.float32))[0]
    assert (cam2.width, cam2.height) == (1226, 370)


def test_the_benchmark_configuration_gives_the_published_files_camera():
    cfg = harness.slam_config(harness.Cell(CELL).config)
    assert cfg.camera == KITTI_CAMERA
    assert cfg.orb == KITTI_ORB
    assert cfg.use_motion_model
    assert (cfg.map.n_features, cfg.map.n_levels, cfg.map.scale_factor) == (2000, 8, 1.2)


def test_orb_slam1_files_give_the_config_they_always_gave(tmp_path):
    path = write(tmp_path, ORB_SLAM1_SETTINGS)
    for cam, orb, extras in (tset.slam_config_from_settings(path),
                             settings_for_images(path, np.zeros((480, 640), np.float32))):
        assert cam == CameraModel.create(609.2855, 609.3422, 351.4274, 237.7324,
                                         -0.3492, 0.1363, 0.0, 0.0, 640, 480)
        assert orb == ORBConfig()
        jcam, jorb, jextras = jset.slam_config_from_settings(path)
        assert cam == camera_from_numpy(
            {k: np.asarray(v) for k, v in jcam._asdict().items()})
        assert orb == orb_config_from_dict(dataclasses.asdict(jorb))
        assert extras == jextras
    # the benchmark's ORB-SLAM1 configuration, as the program reads it
    cfg = harness.slam_config(harness.Cell("tum-fast.creep-batch").config)
    assert cfg.orb == ORBConfig()
    assert cfg.camera == CameraModel.create(609.2855, 609.3422, 351.4274, 237.7324,
                                            width=640, height=480)


@pytest.mark.parametrize("extra, fast_th", [
    ("ORBextractor.fastTh: 20\n", 20.0),
    ("ORBextractor.fastTh: 12\n", None),
])
def test_both_initial_thresholds_must_agree(tmp_path, extra, fast_th):
    path = write(tmp_path, KITTI00_02 + extra)
    if fast_th is None:
        with pytest.raises(ValueError, match="iniThFAST"):
            tset.slam_config_from_settings(path)
    else:
        assert tset.slam_config_from_settings(path)[1].fast_th_ini == fast_th


def test_the_extractor_equals_the_reference_on_a_full_size_street_frame():
    cell = harness.Cell(CELL)
    cfg = harness.slam_config(cell.config)
    tr = dict(cell.traffic["trajectory"])
    pose = TRAJECTORIES[tr.pop("kind")](41, **tr)[40]
    scene, _, _ = harness.scene_frames(
        cell.config, {**cell.traffic, "prefix_frames": 0, "episode_frames": 0})
    img = torch.from_numpy(scene.render_image(pose))
    assert tuple(img.shape) == (376, 1241)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        f = ORBExtractor(cfg.orb, 376, 1241, device="cpu")(img)
        num = harness.reference_numbers(cell.config)
        ref = Extractor(num["n_features"], num["n_levels"], num["scale_factor"],
                        num["fast_th"], num["score_harris"], num["height"],
                        num["width"], "cpu")(img)
    finally:
        torch.set_num_threads(n)
    assert int(ref["valid"].sum()) > 1500
    got = dict(xy=f.xy, angle=f.angle, octave=f.octave, desc=f.desc_i32, valid=f.valid)
    assert check.features_differ(got, ref) == 0.0


def test_the_tracking_counters_count_what_the_host_read(tmp_path, monkeypatch):
    # from the two seeded keyframes: the suite's observation cap of 16
    # (conftest.py) loses the cut street's noiseless prefix at its 8th
    # frame, where the program's cap of 32 keeps it
    root, bench = tiny.make_root(tmp_path, CELL, prefix_frames=0, episode_frames=12)
    cell = harness.Cell(CELL, bench, root)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        setup = harness.build(cell, torch.device("cpu"))
        s, frames = setup.s, harness.takes_of(cell, setup, 7)[0]
        timer = s._stage_timer = StageTimer(sync=False)
        read, handed, poses = [], [], []   # the inliers the host read
        calls = []
        orig_tf = tsys.track_frame
        monkeypatch.setattr(tsys, "track_frame",
                            lambda *a, **k: calls.append(orig_tf(*a, **k)) or calls[-1])

        def apply_chunk(orig):
            def f(feats, xy_und, res, n, ts_list):
                consumed, out = orig(feats, xy_und, res, n, ts_list)
                # a weak frame's count is its re-track's, read in _track
                read.extend(k for k in res.n_inliers[:consumed].tolist()
                            if k >= s.cfg.min_track_inliers)
                return consumed, out
            return f

        def track(orig):
            def f(frame):
                calls.clear()
                T = orig(frame)
                if T is not None:
                    read.append(int(calls[-1].n_inliers))
                return T
            return f

        tokens = [harness.wrap(s, "_apply_chunk", apply_chunk),
                  harness.wrap(s, "_track", track)]
        harness.episode(s, setup.snap, frames, cell.traffic["frames_per_call"],
                        lambda k, dt, p: (handed.append(k), poses.extend(p)))
        harness.unwrap(s, tokens)
    finally:
        torch.set_num_threads(n)
    c = timer.counters
    lost = sum(p is None for p in poses)
    assert sum(handed) == len(poses) == 12
    # both ways in: the chunk's replay and single frames through _track
    assert c["chunk.frames_used"] and c["frames.single"]
    assert sum(c["track.frames"]) == len(c["track.frames"]) == len(poses) - lost
    assert c["track.inliers"] == read
    assert min(read) >= s.cfg.min_track_inliers
    # the reader finds the counters where the harness's stage hook keeps them
    r = harness.Readings(spans={"stages": timer.times})
    assert harness.reader(harness.ROOT, "track.inliers_per_frame")(r) == pytest.approx(
        sum(read) / len(read))
