"""A benchmark root at a size the CPU runs in seconds: a cell with its
configuration cut to 300 features and 4 levels, a 512-slot BA and a
32-keyframe map, and 8-frame episodes after an 8-frame prefix. A box
scene is cut to 400 points in a box of extent (8, 5, 4) seen by a 320x240
camera from x = 0; a street scene keeps its layout, its path kind and
the camera's aspect, at 480 pixels wide with the focal lengths and the
squares' size scaled,
over the first 64 m of its street with the points that lie there, at
most 2000, and its step cut as its street is, so that a point nears the
camera by the same share of its distance each frame. Only the tests use
it."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from slam_bench import harness
from slam_bench.scene import SyntheticScene


def cut_street(settings: dict, scene: dict, path: dict):
    """Cut a street scene, its camera and its path in place (module
    docstring)."""
    scale = 480 / settings["Camera.width"]
    settings.update({"Camera.width": 480,
                     "Camera.height": round(settings["Camera.height"] * scale)})
    for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy"):
        settings[k] *= scale
    scene["patch"] = scene.get("patch", SyntheticScene.patch) * scale
    z0, z1 = scene["z_range"]
    length = min(z1 - z0, 64.0)
    scene.update(z_range=[z0, z0 + length],
                 n_points=min(2000, round(scene["n_points"] * length / (z1 - z0))))
    path["step"] *= length / (z1 - z0)


def make_root(tmp: Path, cell: str, frames_per_call: int = None,
              episode_frames: int = 8, prefix_frames: int = 8,
              step: float = None, bench: dict = None,
              src: Path = harness.ROOT) -> tuple:
    """(root directory, BENCHMARK.json dict) with `cell` pointing at the
    cut configuration and mix. The cell is BENCHMARK.json's, or `bench`'s
    with its files under `src`."""
    if bench is None:
        with open(harness.BENCHMARK_JSON) as f:
            bench = json.load(f)
    bench = json.loads(json.dumps(bench))
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(harness.ROOT / "metrics", tmp / "metrics", dirs_exist_ok=True)
    config = harness.load_json(src, "configs", entry["config"])
    traffic = harness.load_json(src, "traffic", entry["traffic"])
    if traffic["scene"].get("layout", "box") == "street":
        cut_street(config["settings"], traffic["scene"], traffic["trajectory"])
    else:
        config["settings"].update({
            "Camera.width": 320, "Camera.height": 240, "Camera.fx": 250.0,
            "Camera.fy": 250.0, "Camera.cx": 160.0, "Camera.cy": 120.0})
        traffic["scene"].update(n_points=400, extent=[8.0, 5.0, 4.0])
        traffic["trajectory"]["start_x"] = 0.0
    config["settings"].update({"ORBextractor.nFeatures": 300,
                               "ORBextractor.nLevels": 4})
    config["slam"].update({"max_keyframes": 32, "max_points": 4096,
                           "max_ba_points": 512})
    traffic["episode_frames"] = episode_frames
    traffic["prefix_frames"] = prefix_frames
    traffic["takes"] = 2
    if frames_per_call:
        traffic["frames_per_call"] = frames_per_call
    if step:
        traffic["trajectory"]["step"] = step
    entry["config"], entry["traffic"] = "tiny", "tiny"
    for kind, obj in (("configs", config), ("traffic", traffic)):
        with open(tmp / kind / "tiny.json", "w") as f:
            json.dump(obj, f)
    shutil.copy(src / "limits" / f"{cell}.json", tmp / "limits")
    return tmp, bench


DRIVE_CELL = "kitti-shaped.drive-batch"


def write_drive_cell(root: Path) -> dict:
    """Write a driving cell's files under `root` from nothing but data: a
    configuration with the camera and extractor of ORB-SLAM2's
    Examples/Monocular/KITTI00-02.yaml (1241x376 at 10 Hz, 2000 features)
    and tum-fast's `slam`, a mix that drives 0.8 m a frame down a street
    (KITTI 00: ~3.7 km in 4,541 frames) of squares about 1 m across
    (`patch` 60), and tum-fast.creep-batch's limits. Returns
    BENCHMARK.json with the cell added."""
    config = {"source": "https://github.com/raulmur/ORB_SLAM2/blob/master/"
                        "Examples/Monocular/KITTI00-02.yaml",
              "slam": harness.load_json(harness.ROOT, "configs", "tum-fast")["slam"]}
    config["settings"] = {
        "Camera.fx": 718.856, "Camera.fy": 718.856, "Camera.cx": 607.1928,
        "Camera.cy": 185.2157, "Camera.k1": 0.0, "Camera.k2": 0.0,
        "Camera.p1": 0.0, "Camera.p2": 0.0, "Camera.width": 1241,
        "Camera.height": 376, "Camera.fps": 10.0, "Camera.RGB": 1,
        "ORBextractor.nFeatures": 2000, "ORBextractor.scaleFactor": 1.2,
        "ORBextractor.nLevels": 8, "ORBextractor.fastTh": 20,
        "ORBextractor.nScoreType": 1, "UseMotionModel": 1}
    traffic = {
        "scene": {"layout": "street", "n_points": 12000, "seed": 0, "patch": 60,
                  "half_width": 6.0, "facade_depth": 3.0, "facade_height": 6.0,
                  "camera_height": 1.65, "road_share": 0.3, "z_range": [0.0, 290.0],
                  "noise": 2.0},
        "trajectory": {"kind": "forward", "step": 0.8, "yaw_rate": 0.004,
                       "yaw_period": 128, "start_x": 0.0, "start_z": 0.0},
        "prefix_frames": 192, "episode_frames": 64, "frames_per_call": 8,
        "takes": 3}
    config_name, mix = DRIVE_CELL.split(".")
    for kind, name, obj in (("configs", config_name, config), ("traffic", mix, traffic)):
        (root / kind).mkdir(parents=True, exist_ok=True)
        with open(root / kind / f"{name}.json", "w") as f:
            json.dump(obj, f, indent=1)
    (root / "limits").mkdir(parents=True, exist_ok=True)
    shutil.copy(harness.ROOT / "limits" / "tum-fast.creep-batch.json",
                root / "limits" / f"{DRIVE_CELL}.json")
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": DRIVE_CELL, "config": config_name,
                               "traffic": mix, "chips": 1, "why": "a drive"})
    # the metrics a cell reports are those that list it
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(DRIVE_CELL)
    return bench


def run(tmp: Path, cell: str, seed: int = 5, trace: bool = False, **kw):
    root, bench = make_root(tmp, cell, **kw)
    return harness.run(cell, seed, 0.01, trace, bench=bench, root=root,
                       device="cpu", require_card=False, log=lambda m: None)
