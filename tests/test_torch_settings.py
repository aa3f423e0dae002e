"""The port's settings loader against the JAX one (PyYAML) on the
reference's flat schema: the fixture texts of tests/test_harris_fallback.py
(nScoreType 0) and tests/test_cli.py (nScoreType 1), an OpenCV-style file
with comments and a matrix tag, and an empty file. Exact: the same keys
and scalars, the same configuration (camera values as float32, as the
JAX CameraModel stores them). The port's module needs no yaml package.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from orb_slam_tpu.io import settings as jset
from orb_slam_tpu_torch.convert import camera_from_numpy, orb_config_from_dict
from orb_slam_tpu_torch.io import settings as tset

REPO = Path(__file__).resolve().parents[1]

HARRIS = (
    "%YAML:1.0\n"
    "Camera.fx: 200.0\nCamera.fy: 200.0\n"
    "Camera.cx: 160.0\nCamera.cy: 120.0\n"
    "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
    "Camera.fps: 30.0\nCamera.width: 320\nCamera.height: 240\n"
    "ORBextractor.nFeatures: 300\nORBextractor.scaleFactor: 1.2\n"
    "ORBextractor.nLevels: 8\nORBextractor.fastTh: 20\n"
    "ORBextractor.nScoreType: 0\n")

CLI = """\
%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.fps: 30.0
Camera.RGB: 1
Camera.width: 320
Camera.height: 240
ORBextractor.nFeatures: 400
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.fastTh: 20
ORBextractor.nScoreType: 1
UseMotionModel: 1
"""

OPENCV = """\
%YAML:1.0
---
#--------------------------------------------------------------------------
# Camera Parameters. Adjust them!
#--------------------------------------------------------------------------

# Camera calibration parameters (OpenCV)
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989

Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628   # tangential
Camera.RGB: 0
Camera.Name: !!opencv-matrix "TUM1"
UseMotionModel: false
ORBextractor.nScoreType: 0
"""

TEXTS = {"harris_fallback": HARRIS, "cli": CLI, "opencv": OPENCV, "empty": ""}


@pytest.mark.parametrize("name", list(TEXTS))
def test_settings_match_jax(tmp_path, name):
    path = tmp_path / "settings.yaml"
    path.write_text(TEXTS[name])
    assert tset.load_settings(str(path)) == jset.load_settings(str(path))
    jcam, jorb, jextras = jset.slam_config_from_settings(str(path))
    cam, orb, extras = tset.slam_config_from_settings(str(path))
    assert cam == camera_from_numpy(
        {k: np.asarray(v) for k, v in jcam._asdict().items()})
    assert orb == orb_config_from_dict(dataclasses.asdict(jorb))
    assert extras == jextras
    assert orb.score_harris == (name in ("harris_fallback", "opencv"))


def test_nested_value_raises(tmp_path):
    path = tmp_path / "settings.yaml"
    path.write_text("Camera:\n  fx: 500.0\n")
    with pytest.raises(ValueError, match="nested"):
        tset.load_settings(str(path))


def test_settings_module_needs_no_yaml(tmp_path):
    """The port's settings module imports and parses with yaml blocked."""
    path = tmp_path / "settings.yaml"
    path.write_text(HARRIS)
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['jax'] = None\n"
        "from orb_slam_tpu_torch.io import settings\n"
        "cam, orb, extras = settings.slam_config_from_settings(sys.argv[1])\n"
        "assert orb.score_harris and cam.width == 320\n")
    out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("harris", [False, True])
def test_settings_text_round_trip(tmp_path, harris):
    """settings_text writes what both loaders read back as the same
    configuration (a tiny distortion coefficient included: YAML 1.1 reads
    1e-05 as a string, 1.0e-05 as a float)."""
    from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig
    from orb_slam_tpu_torch.geometry.camera import CameraModel

    cam = CameraModel(517.306396484375, 516.4692, 318.64304, 255.31399,
                      k1=0.262383, k2=1e-05, p1=-0.005358, p2=0.002628,
                      width=640, height=480)
    cam = camera_from_numpy(dataclasses.asdict(cam))     # float32 values
    orb = ORBConfig(n_features=1200, n_levels=6, scale_factor=1.25,
                    fast_th_ini=18.0, score_harris=harris)
    path = tmp_path / "settings.yaml"
    path.write_text(tset.settings_text(cam, orb, fps=20.0,
                                       use_motion_model=False))
    got_cam, got_orb, extras = tset.slam_config_from_settings(str(path))
    assert (got_cam, got_orb) == (cam, orb)
    assert extras["fps"] == 20.0 and extras["use_motion_model"] is False
    assert tset.load_settings(str(path)) == jset.load_settings(str(path))
