"""`correct` on small runs on the CPU: a sound run passes, the control
fails, and so does a run with the timed path broken underneath, once for
each fault a cell can have."""

import json

import pytest
import torch

from slam_bench import check, faults, harness
from slam_bench.tests import tiny

CELL = "tum-fast.creep-batch"


def failed_numbers(result):
    return [k for k, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]]


def test_a_sound_run_is_correct(tmp_path):
    res = tiny.run(tmp_path, CELL)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 8
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]
    # no card here, so no profile of the window: the card's time is not
    # read, never 0
    assert "card_ms_per_frame" not in res["metrics"]


def test_a_traced_run_reads_its_per_layer_metrics(tmp_path):
    # one frame per call at 8 cm/frame: the per-frame path, with keyframes
    res = tiny.run(tmp_path, CELL, trace=True, episode_frames=4, frames_per_call=1,
                   step=0.08)
    assert res["correct"], res["checks"]
    assert {"closed_loop.frames_per_s", "mapping.integrate_ms_p50", "local_ba.ms_per_kf",
            "mapping.neighbors_per_kf", "local_ba.cams_per_kf"} <= set(res["metrics"])
    assert res["metrics"]["local_ba.cams_per_kf"]["value"] >= 2
    # no card here, so no profile: the trace's readers read nothing, never 0
    assert "K1_roofline" not in res["metrics"]
    assert "device.idle_pct" not in res["metrics"]
    assert "window_s" not in res["device"]


def test_a_driving_cell_from_files_alone_runs_and_is_checked(tmp_path):
    # a street and a forward path, from nothing but the cell's files
    bench = tiny.write_drive_cell(tmp_path / "files")
    res = tiny.run(tmp_path / "cut", tiny.DRIVE_CELL, bench=bench,
                   src=tmp_path / "files")
    line = json.loads(json.dumps(res))
    assert set(line["checks"]) == {
        "features_differ", "track_pose_gap_px_p90", "kf_pose_gap_px_p90",
        "point_gap_px", "wrong_point_share", "frames_unanswered"}
    assert all(c["value"] is not None for c in line["checks"].values())
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 8


def test_the_control_fails(tmp_path):
    root, bench = tiny.make_root(tmp_path, CELL)
    cell = harness.Cell(CELL, bench, root)
    dev = torch.device("cpu")
    setup = harness.build(cell, dev)
    frames = harness.takes_of(cell, setup, 9)[0]
    capture = check.Capture(base=setup.truth["base"])
    rec = harness.install_capture(setup.s, capture)
    harness.episode(setup.s, setup.snap, frames, cell.traffic["frames_per_call"])
    harness.remove_capture(setup.s, rec)
    limits = cell.limits()
    program = harness.judge(cell, capture, frames, 0, dev, setup.truth)
    control = harness.judge(cell, capture, frames, 0, dev, setup.truth, control=True)
    assert check.verdict(program, limits)[0], program
    assert not check.verdict(control, limits)[0], control
    assert control["features_differ"] > limits["features_differ"]
    # pixels here are half the cell's, so the control's pose gap is held
    # against the program's own rather than the cell's limit
    assert control["track_pose_gap_px_p90"] > 100 * program["track_pose_gap_px_p90"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    with faults.planted(fault):
        res = tiny.run(tmp_path, CELL)
    assert not res["correct"], res["checks"]
    assert failed_numbers(res)


def test_rebound_bindings_read_as_wrong_points(tmp_path):
    with faults.planted("rebind"):
        res = tiny.run(tmp_path, CELL)
    c = res["checks"]["wrong_point_share"]
    assert c["value"] > c["limit"], c


def test_rebind_moves_every_fifth_binding():
    obs = torch.tensor([[5, -1, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, -1]])
    got = faults.rebind(obs)
    # the bindings at positions 0, 5 and 10 of the row's 12 (slots 0, 6
    # and 11) move one step round
    assert got[0, 0] == 10 and got[0, 6] == 15 and got[0, 11] == 5
    keep = [i for i in range(14) if i not in (0, 6, 11)]
    assert (got[0, keep] == obs[0, keep]).all()
