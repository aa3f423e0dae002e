"""Every cell, configuration, mix, limit file and metric reader loads by
name, and a new one is found from its file alone."""

import json
import shutil

from slam_bench import harness


def bench():
    with open(harness.BENCHMARK_JSON) as f:
        return json.load(f)


def test_every_entry_loads_by_name():
    b = bench()
    for w in b["workloads"]:
        cell = harness.Cell(w["name"], b)
        assert cell.config["settings"]["Camera.width"] == 640
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
