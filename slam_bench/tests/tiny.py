"""A benchmark root at a size the CPU runs in seconds: the cells of
BENCHMARK.json with their configuration cut to 320x240, 300 features and
4 levels, a 512-slot BA and a 32-keyframe map, and 8-frame episodes after
an 8-frame prefix over 400 scene points. Only the tests use it."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from slam_bench import harness


def make_root(tmp: Path, cell: str, frames_per_call: int = None,
              episode_frames: int = 8, prefix_frames: int = 8,
              step: float = None) -> tuple:
    """(root directory, BENCHMARK.json dict) with `cell` pointing at the
    cut configuration and mix."""
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(harness.ROOT / "metrics", tmp / "metrics", dirs_exist_ok=True)
    config = harness.load_json(harness.ROOT, "configs", entry["config"])
    config["settings"].update({
        "Camera.width": 320, "Camera.height": 240, "Camera.fx": 250.0,
        "Camera.fy": 250.0, "Camera.cx": 160.0, "Camera.cy": 120.0,
        "ORBextractor.nFeatures": 300, "ORBextractor.nLevels": 4})
    config["slam"].update({"max_keyframes": 32, "max_points": 4096,
                           "max_ba_points": 512})
    traffic = harness.load_json(harness.ROOT, "traffic", entry["traffic"])
    traffic["episode_frames"] = episode_frames
    traffic["prefix_frames"] = prefix_frames
    traffic["scene"].update(n_points=400, extent=[8.0, 5.0, 4.0])
    traffic["trajectory"]["start_x"] = 0.0
    traffic["takes"] = 2
    if frames_per_call:
        traffic["frames_per_call"] = frames_per_call
    if step:
        traffic["trajectory"]["step"] = step
    entry["config"], entry["traffic"] = "tiny", "tiny"
    for kind, obj in (("configs", config), ("traffic", traffic)):
        with open(tmp / kind / "tiny.json", "w") as f:
            json.dump(obj, f)
    shutil.copy(harness.ROOT / "limits" / f"{cell}.json", tmp / "limits")
    return tmp, bench


def run(tmp: Path, cell: str, seed: int = 5, trace: bool = False, **kw):
    root, bench = make_root(tmp, cell, **kw)
    return harness.run(cell, seed, 0.01, trace, bench=bench, root=root,
                       device="cpu", require_card=False, log=lambda m: None)
