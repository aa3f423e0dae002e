"""Settings files: the reference's flat schema (Data/Settings.yaml), and
ORB-SLAM2's monocular files (Examples/Monocular/*.yaml).

Port of orb_slam_tpu/io/settings.py: `load_settings` (:15-26) and
`slam_config_from_settings` (:29-53), returning the port's CameraModel
and ORBConfig; `settings_text` writes a configuration back in the same
schema (chip_smoke.py and profile_paths.py build the Harris path from
such a file). Keys: Camera.{fx,fy,cx,cy,k1,k2,p1,p2,width,height,fps,RGB},
ORBextractor.{nFeatures,scaleFactor,nLevels,fastTh,nScoreType} and
UseMotionModel; nScoreType 0 selects the Harris ranking. Beyond JAX, the
port reads ORB-SLAM2's two FAST thresholds: `ORBextractor.iniThFAST`, the
initial threshold where the file gives no `fastTh` (a file that gives
both, with different values, raises), and `ORBextractor.minThFAST`, the
lower one (`ORBConfig.fast_th_min`, 7 where the file gives none). Neither
schema gives the frame size in every file (ORB-SLAM reads it from the
images): the caller passes `width` and `height` for a file without
`Camera.width` and `Camera.height` (cli.py passes the first image's).

The JAX loader hands the text to PyYAML after dropping the "%YAML" and
"---" lines and the "!!opencv-matrix" tags. This port reads the same flat
`Key: value` text itself, with PyYAML's rules for plain scalars (YAML 1.1
bools, ints, floats that have a dot, null), so it needs no yaml package.
A nested value (a matrix node) raises ValueError.
"""

from __future__ import annotations

import re

from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig
from orb_slam_tpu_torch.geometry.camera import CameraModel

# PyYAML's implicit resolvers for plain scalars (yaml/resolver.py)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# a comment starts a line or follows white space, outside quotes
_COMMENT = re.compile(r"""(?:^|\s)#[^'"]*$""")


def _scalar(text: str):
    """A plain or quoted YAML scalar as PyYAML's safe_load reads it."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        return float("nan") if t.endswith("nan") else float(t)
    return text


def load_settings(path: str) -> dict:
    """{key: scalar} of a flat settings file."""
    out = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if line.startswith("%YAML") or line.startswith("---"):
                continue
            text = _COMMENT.sub("", line.replace("!!opencv-matrix", ""))
            if not text.strip():
                continue
            key, sep, value = text.partition(":")
            if not sep or text[0].isspace():
                raise ValueError(f"{path}:{n}: not a flat 'Key: value' line "
                                 f"(nested values are not supported): {line!r}")
            out[key.strip()] = _scalar(value.strip())
    return out


def slam_config_from_settings(path: str, width: int = 640, height: int = 480):
    """(CameraModel, ORBConfig, extras) from a settings file. Camera values
    are kept as float32, as the JAX CameraModel stores them."""
    raw = load_settings(path)
    g = lambda k, d: raw.get(k, d)
    ini_th = g("ORBextractor.iniThFAST", 20)
    fast_th = g("ORBextractor.fastTh", ini_th)
    if "ORBextractor.iniThFAST" in raw and float(fast_th) != float(ini_th):
        raise ValueError(f"{path}: ORBextractor.fastTh {fast_th} and "
                         f"ORBextractor.iniThFAST {ini_th} disagree; both name "
                         f"the initial FAST threshold")
    cam = CameraModel.create(
        fx=g("Camera.fx", 500.0), fy=g("Camera.fy", 500.0),
        cx=g("Camera.cx", width / 2), cy=g("Camera.cy", height / 2),
        k1=g("Camera.k1", 0.0), k2=g("Camera.k2", 0.0),
        p1=g("Camera.p1", 0.0), p2=g("Camera.p2", 0.0),
        width=g("Camera.width", width), height=g("Camera.height", height),
    )
    orb = ORBConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        fast_th_ini=float(fast_th),
        fast_th_min=float(g("ORBextractor.minThFAST", 7.0)),
        score_harris=int(g("ORBextractor.nScoreType", 1)) == 0,
    )
    extras = {
        "fps": float(g("Camera.fps", 30.0)),
        "rgb": bool(g("Camera.RGB", 1)),
        "use_motion_model": bool(g("UseMotionModel", 1)),
        "score_type": int(g("ORBextractor.nScoreType", 1)),
    }
    return cam, orb, extras


def _float_text(v) -> str:
    """A float as a YAML 1.1 float (PyYAML wants a dot: 1e-05 -> 1.0e-05)."""
    text = repr(float(v))
    if "e" in text and "." not in text:
        mantissa, exp = text.split("e")
        text = f"{mantissa}.0e{exp}"
    return text


def settings_text(cam: CameraModel, orb: ORBConfig, fps: float = 30.0,
                  use_motion_model: bool = True) -> str:
    """The flat settings text that `slam_config_from_settings` reads back
    as (cam, orb) in the reference's schema (fast_th_min, which only
    ORB-SLAM2's files carry, edge_threshold, cell_size and the descriptor
    options are not in it and keep their defaults)."""
    return "\n".join([
        "%YAML:1.0",
        f"Camera.fx: {_float_text(cam.fx)}", f"Camera.fy: {_float_text(cam.fy)}",
        f"Camera.cx: {_float_text(cam.cx)}", f"Camera.cy: {_float_text(cam.cy)}",
        f"Camera.k1: {_float_text(cam.k1)}", f"Camera.k2: {_float_text(cam.k2)}",
        f"Camera.p1: {_float_text(cam.p1)}", f"Camera.p2: {_float_text(cam.p2)}",
        f"Camera.width: {cam.width}", f"Camera.height: {cam.height}",
        f"Camera.fps: {_float_text(fps)}",
        f"ORBextractor.nFeatures: {orb.n_features}",
        f"ORBextractor.scaleFactor: {_float_text(orb.scale_factor)}",
        f"ORBextractor.nLevels: {orb.n_levels}",
        f"ORBextractor.fastTh: {_float_text(orb.fast_th_ini)}",
        f"ORBextractor.nScoreType: {0 if orb.score_harris else 1}",
        f"UseMotionModel: {int(use_motion_model)}", ""])
