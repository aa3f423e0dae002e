"""Every cell, configuration, mix, limit file and metric reader loads by
name, and a new one is found from its file alone."""

import json
import shutil

import pytest

from slam_bench import harness, roofline
from slam_bench.tests import tiny


def bench():
    with open(harness.BENCHMARK_JSON) as f:
        return json.load(f)


def assert_frame_size_holds(settings):
    """Width and height are positive whole numbers, and the pyramid's last
    level is at least 32 pixels on each side."""
    w, h = settings["Camera.width"], settings["Camera.height"]
    assert isinstance(w, int) and isinstance(h, int) and w > 0 and h > 0
    last = roofline.pyramid_shapes(h, w, settings["ORBextractor.nLevels"],
                                   settings["ORBextractor.scaleFactor"])[-1]
    assert min(last) >= 32, last


def test_every_entry_loads_by_name():
    b = bench()
    for w in b["workloads"]:
        cell = harness.Cell(w["name"], b)
        assert_frame_size_holds(cell.config["settings"])
        assert cell.traffic["frames_per_call"] >= 1
        assert set(cell.limits()) >= {"features_differ", "track_pose_gap_px_p90",
                                      "wrong_point_share", "frames_unanswered"}
        assert cell.traffic["prefix_frames"] >= 0
        e2e, per = cell.e2e, cell.per_layer
        assert {"card_ms_per_frame", "setup_s"} <= {m["name"] for m in e2e}
        assert per
    for c in b["configs"]:
        assert (harness.ROOT.parent / c["file"]).is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(harness.ROOT, m["name"]))


def test_a_new_cell_is_found_from_files_alone(tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("tests"))
    cfg = harness.load_json(root, "configs", "tum-fast")
    cfg["settings"]["ORBextractor.nFeatures"] = 2000
    (root / "configs" / "kitti-like.json").write_text(json.dumps(cfg))
    mix = harness.load_json(root, "traffic", "creep-batch")
    mix["frames_per_call"] = 4
    (root / "traffic" / "creep-4.json").write_text(json.dumps(mix))
    (root / "limits" / "kitti-like.creep-4.json").write_text(
        json.dumps({"features_differ": 0.0}))
    (root / "metrics" / "episodes.py").write_text(
        "def read(r):\n    return float(r.episodes)\n")
    b = bench()
    b["workloads"].append({"name": "kitti-like.creep-4", "config": "kitti-like",
                           "traffic": "creep-4", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "episodes", "unit": "episodes", "better": "higher",
                           "source": "host_clock", "layer": "harness",
                           "moves": "card_ms_per_frame"})
    cell = harness.Cell("kitti-like.creep-4", b, root)
    assert cell.config["settings"]["ORBextractor.nFeatures"] == 2000
    assert cell.traffic["frames_per_call"] == 4
    assert cell.limits() == {"features_differ": 0.0}
    assert "episodes" in {m["name"] for m in cell.per_layer}
    assert harness.reader(root, "episodes")(harness.Readings(episodes=3)) == 3.0


def test_a_driving_cell_is_found_from_files_alone(tmp_path):
    # 1241x376 frames down a street, from a configuration, a mix and a
    # limits file that name nothing the harness does not read
    b = tiny.write_drive_cell(tmp_path)
    cell = harness.Cell(tiny.DRIVE_CELL, b, tmp_path)
    st = cell.config["settings"]
    assert (st["Camera.width"], st["Camera.height"]) == (1241, 376)
    assert_frame_size_holds(st)
    assert cell.traffic["scene"]["layout"] == "street"
    assert cell.traffic["trajectory"]["kind"] == "forward"
    assert cell.limits() == harness.Cell("tum-fast.creep-batch", bench()).limits()
    assert {"card_ms_per_frame", "setup_s"} <= {m["name"] for m in cell.e2e}
    assert {"K1_roofline", "K5_roofline"} <= {m["name"] for m in cell.per_layer}
    mix = {**cell.traffic, "prefix_frames": 0, "episode_frames": 2}
    scene, poses, frames = harness.scene_frames(cell.config, mix)
    assert frames.shape == (4, 376, 1241)
    assert scene.points.shape == (12000, 3)
    centre = -poses[-1, :3, :3].T @ poses[-1, :3, 3]
    assert centre[2] == pytest.approx(3 * 0.8, abs=1e-3)
    assert 0.05 < (scene.billboard_index(poses[-1]) >= 0).mean() < 1.0


def test_per_layer_metrics_follow_their_workloads():
    m = lambda name, moves, **kw: {"name": name, "moves": moves, **kw}
    b = {"end_to_end": [m("rate", None), m("tail", None, workloads=["live"])],
         "per_layer": [m("a", "rate"), m("b", "tail"), m("c", "rate", workloads=["batch"])]}
    e2e, per = harness.cell_metrics(b, "live")
    assert [x["name"] for x in e2e] == ["rate", "tail"]
    assert [x["name"] for x in per] == ["a", "b"]
    e2e, per = harness.cell_metrics(b, "batch")
    assert [x["name"] for x in e2e] == ["rate"]
    assert [x["name"] for x in per] == ["a", "c"]
    creep = harness.Cell("tum-fast.creep-batch", bench())
    assert {"chunk.ms_per_frame", "K1_roofline", "local_ba.cams_per_kf"} <= {
        x["name"] for x in creep.per_layer}
