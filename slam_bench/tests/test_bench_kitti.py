"""The `kitti-mono.drive-batch` cell: found from BENCHMARK.json and its
files; its mix and configuration are the driving cell's that
`tiny.write_drive_cell` writes, key for key, so the drive rehearsed from
those files is the one measured; the reader of `track.inliers_per_frame`
on hand-made counters, and nothing without them; and K1's and K5's
rooflines counted at 1241x376 and 2000 features."""

import json

import pytest

from slam_bench import harness, roofline
from slam_bench.harness import ROOT, Readings, reader
from slam_bench.tests import tiny
from slam_bench.trace import Trace

CELL = "kitti-mono.drive-batch"


def bench():
    with open(harness.BENCHMARK_JSON) as f:
        return json.load(f)


def test_the_cell_is_found_from_benchmark_json():
    b = bench()
    cell = harness.Cell(CELL, b)
    assert cell.entry["chips"] == 1
    st = cell.config["settings"]
    assert (st["Camera.width"], st["Camera.height"], st["ORBextractor.nFeatures"]) == (
        1241, 376, 2000)
    assert cell.config["reduced"] == []
    assert next(c for c in b["configs"] if c["name"] == "kitti-mono")["reduced"] == []
    assert (cell.traffic["scene"]["layout"], cell.traffic["trajectory"]["kind"]) == (
        "street", "forward")
    assert set(cell.limits()) == set(harness.Cell("tum-fast.creep-batch", b).limits())
    assert {m["name"] for m in cell.e2e} == {"card_ms_per_frame", "setup_s"}
    # every per-layer metric reads the drive
    assert {m["name"] for m in cell.per_layer} == {m["name"] for m in b["per_layer"]}
    assert "track.inliers_per_frame" in {m["name"] for m in cell.per_layer}


def test_the_committed_drive_is_the_rehearsed_one(tmp_path):
    tiny.write_drive_cell(tmp_path)
    config_name, mix = tiny.DRIVE_CELL.split(".")
    rehearsed = harness.load_json(tmp_path, "traffic", mix)
    committed = harness.Cell(CELL).traffic
    for key, value in rehearsed.items():
        assert committed[key] == value, key
    # what the committed mix adds only describes it
    assert set(committed) - set(rehearsed) == {"loop", "stands_for"}
    assert committed["loop"] == "closed"
    rehearsed_cfg = harness.load_json(tmp_path, "configs", config_name)
    committed_cfg = harness.Cell(CELL).config
    assert committed_cfg["settings"] == rehearsed_cfg["settings"]
    assert committed_cfg["slam"] == rehearsed_cfg["slam"]
    assert committed_cfg["source"] == rehearsed_cfg["source"]


@pytest.mark.parametrize("stages, value", [
    ({"track.inliers": [40, 61, 89], "track.frames": [1, 1, 1]}, 190 / 3),
    ({"track.inliers": [40, 61, 89], "track.frames": [1, 1, 1],
      "chunk.extract": [0.001] * 3, "fuse": [0.07]}, 190 / 3),
    ({}, None),
    ({"chunk.extract": [0.001] * 3, "fuse": [0.07]}, None),
    ({"track.inliers": [], "track.frames": []}, None),
])
def test_the_inliers_reader_on_hand_made_counters(stages, value):
    read = reader(ROOT, "track.inliers_per_frame")
    got = read(Readings(spans={"stages": stages}))
    assert got == (None if value is None else pytest.approx(value))
    assert read(Readings(spans={})) is None


def test_the_rooflines_count_the_drives_shapes():
    config = harness.Cell(CELL).config
    shapes = roofline.pyramid_shapes(376, 1241, 8, 1.2)
    assert shapes[0] == (376, 1241) and shapes[-1] == (105, 346)
    px = sum(h * w for h, w in shapes)
    # K1: each level pixel read once and its score written
    assert roofline.k1_work(shapes) == (8 * px, px * (roofline.FAST_SCORE_OPS
                                                      + roofline.NMS_OPS
                                                      + roofline.MASK_OPS))
    dev = [("fast_score_nms_kernel", "kernel", 0.1, 0.1 + 40e-6),
           ("keypoint_select_cells_kernel", "kernel", 0.2, 0.2 + 30e-6),
           ("keypoint_select_levels_kernel", "kernel", 0.3, 0.3 + 10e-6)]
    r = Readings(config=config, trace=Trace(dev, [], (0.0, 1.0)))
    k1 = reader(ROOT, "K1_roofline")(r)
    assert k1 == pytest.approx(100 * 8 * px / roofline.HBM_BYTES_PER_S / 40e-6)
    # K5: the level pixels once as f32 and L x Qmax x 13 output bytes, over
    # both launches of the one selection
    k5_bytes = 4 * px + 8 * 434 * 13
    k5 = reader(ROOT, "K5_roofline")(r)
    assert k5 == pytest.approx(100 * k5_bytes / roofline.HBM_BYTES_PER_S / 40e-6)
    assert 0 < k5 < 100 and 0 < k1 < 100
