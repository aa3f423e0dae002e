"""The port's command line (orb_slam_tpu_torch/cli.py), datasets, viz,
event log and stage timer, on the CPU (`--device cpu`); tests/test_cli.py
and tests/test_aux.py on the port.

`run` then `eval` on 12 rendered 320x240 frames, and `run --async --chunk
4` on the same frames written as binary PGM, and `--pace`'s hand-over
rule on a stand-in system. `eval` on the same two TUM
files prints the JAX CLI's JSON, each number within 1e-6 (the Sim3
alignment is f32 in both). `draw_frame` is bit-equal to JAX's on the same
inputs; the numpy PGM reader equals PIL's decode of the same file.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu_torch import cli
from orb_slam_tpu_torch.io import dataset as tds
from orb_slam_tpu_torch.io.trajectory import write_tum
from orb_slam_tpu_torch.geometry.so3 import rot_to_quat
from tests.test_cli import SETTINGS


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for torch while this module runs (as
    tests/test_torch_system_map.py: several test processes share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def render(tmp_path, seed, fmt):
    """12 frames of tests/test_cli.py's scene written as `fmt` files; the
    ground truth as a TUM file. Returns (frame dir, gt path, settings)."""
    from PIL import Image

    scene = SyntheticScene(n_points=220, seed=seed, width=320, height=240,
                           fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                           extent=(7.0, 5.0, 3.0), depth_range=(5.5, 8.5))
    poses = lateral_trajectory(12, step=0.12)
    img_dir = tmp_path / "frames"
    img_dir.mkdir()
    for i in range(12):
        img = scene.render_image(poses[i], patch=5)
        if fmt == "pgm":
            tds.write_pgm(str(img_dir / f"{i:06d}.pgm"), img)
        else:
            Image.fromarray(img.astype(np.uint8)).save(str(img_dir / f"{i:06d}.png"))
    settings = tmp_path / "settings.yaml"
    settings.write_text(SETTINGS)
    gt = tmp_path / "gt.txt"
    rows = []
    for i, T in enumerate(np.asarray(poses, np.float64)):
        R_wc = T[:3, :3].T
        rows.append((i, -R_wc @ T[:3, 3], rot_to_quat(torch.from_numpy(R_wc)).numpy()))
    write_tum(str(gt), rows)
    return img_dir, gt, settings


def eval_json(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["eval", *args])
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_run_and_eval(tmp_path, capsys):
    img_dir, gt, settings = render(tmp_path, 21, "png")
    out = tmp_path / "traj.txt"
    cli.main(["run", str(settings), str(img_dir), "--out", str(out),
              "--max-keyframes", "16", "--max-points", "1024", "--device", "cpu"])
    assert "[final] frames=12 " in capsys.readouterr().err
    rows = np.loadtxt(str(out))
    assert rows.shape[0] >= 2 and rows.shape[1] == 8
    result = eval_json(cli.main, str(out), str(gt), "--max-dt", "0.05")
    assert result["n_associated"] >= 2
    assert result["ate_rmse"] < 1.0


def test_run_async_chunked(tmp_path, capsys):
    """`run --async` drives the threaded system through the chunked path,
    from PGM frames; `--stages` prints the stage timer's summary, the
    mapper thread's stages with the tracker's spans, after `[final]`."""
    img_dir, gt, settings = render(tmp_path, 3, "pgm")
    out = tmp_path / "traj_async.txt"
    cli.main(["run", str(settings), str(img_dir), "--out", str(out),
              "--max-keyframes", "16", "--max-points", "1024",
              "--chunk", "4", "--async", "--device", "cpu", "--stages"])
    err = capsys.readouterr().err
    assert "[final] frames=12 " in err and "device=cpu" in err
    report = err[err.index("[final]"):]
    assert "[stages] 12 frames" in report
    assert "frame.single" in report and "frames.single" in report
    rows = np.loadtxt(str(out))
    assert rows.shape[0] >= 2 and rows.shape[1] == 8


class _Recorder:
    """A stand-in system for `cli._run_frames`: records each call's frames
    and its start on the host clock, and takes `busy` seconds a call."""

    state, n_keyframes, n_points, n_loops_closed = 2, 0, 0, 0

    def __init__(self, busy):
        self.busy, self.calls = busy, []

    def process_batch(self, imgs, timestamps=None, chunk_size=None):
        import time
        self.calls.append((time.perf_counter(), list(imgs)))
        time.sleep(self.busy)

    def process(self, img, timestamp=None):
        self.process_batch([img])


@pytest.mark.parametrize("chunk, busy, sizes", [
    (4, 0.0, [1] * 6),             # ahead of the camera: one frame a call
    (4, 0.31, [1, 3, 2]),          # behind: every frame that has arrived
    (2, 0.31, [1, 2, 2, 1]),       # behind: at most a chunk
    (1, 0.0, [1] * 6),             # one frame at a time through process
])
def test_pace_hands_over_frames_as_they_arrive(chunk, busy, sizes, capsys):
    """`run --pace P`: frame i arrives i * P after the first; the caller
    waits for it and first hands over every frame that has arrived, at
    most a chunk (profile_paths.PacedFeed's rule), in order."""
    import argparse
    import time
    pace = 0.1
    args = argparse.Namespace(chunk=chunk, pace=pace, viz_every=0,
                              max_frames=0, viz_out=None)
    system = _Recorder(busy)
    frames = [(i / 30.0, i) for i in range(6)]
    n, t0 = cli._run_frames(args, system, ["?", "?", "OK"], iter(frames))
    assert n == 6
    assert [len(f) for _, f in system.calls] == sizes
    assert [i for _, f in system.calls for i in f] == list(range(6))
    for start, f in system.calls:      # no frame goes in before it arrives
        assert start >= t0 + f[-1] * pace - 1e-3


def test_eval_matches_jax(tmp_path):
    """The same two TUM files through both CLIs' `eval`."""
    from orb_slam_tpu import cli as jcli

    rng = np.random.default_rng(4)
    n = 20
    gt_c = np.cumsum(rng.normal(0, 0.1, (n, 3)), 0)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    est_c = 1.7 * gt_c @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T + 0.3
    est_c += rng.normal(0, 0.01, est_c.shape)
    gt, est = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    write_tum(gt, [(i, gt_c[i], q[i]) for i in range(n)])
    write_tum(est, [(i, est_c[i], q[i]) for i in range(0, n, 2)])
    a = eval_json(cli.main, est, gt)
    b = eval_json(jcli.main, est, gt)
    assert a.keys() == b.keys() and a["n_associated"] == b["n_associated"] == 10
    for k in ("ate_rmse", "rpe_1"):
        assert abs(a[k] - b[k]) <= 1e-6, (k, a[k], b[k])


def test_run_needs_the_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", str(tmp_path / "s.yaml"), str(tmp_path)])


def test_draw_frame_matches_jax():
    from orb_slam_tpu.io.viz import draw_frame as jax_draw
    from orb_slam_tpu_torch.io.viz import draw_frame

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy = rng.uniform(-5, 170, (60, 2))
    mask = rng.random(60) > 0.5
    a = draw_frame(img, xy, mask, "WORKING", 5, 100, 50)
    b = jax_draw(img, xy, mask, "WORKING", 5, 100, 50)
    assert a.shape == (138, 160, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tracked_port_system():
    """The port's SLAMSystem after 14 oracle-feature frames (test_aux.py's
    scene and configuration), on the CPU."""
    from orb_slam_tpu_torch.geometry.camera import CameraModel
    from orb_slam_tpu_torch.pipeline import system as tsys
    from orb_slam_tpu_torch.slam_map.map_state import MapConfig

    scene = SyntheticScene(n_points=400, seed=11)
    cfg = tsys.SlamConfig(
        camera=CameraModel(scene.fx, scene.fy, scene.cx, scene.cy,
                           width=scene.width, height=scene.height),
        orb=None, map=MapConfig(max_keyframes=16, max_points=1024, n_features=200),
        p_local=512, n_triangulation_neighbors=2, n_fuse_neighbors=2,
        local_ba_window=4, enable_loop_closing=False, enable_relocalisation=False)
    s = tsys.SLAMSystem(cfg, device="cpu")
    for p in lateral_trajectory(14, step=0.08):
        s.process(features=scene.observe(p, n_slots=200))
    assert s.state == tsys.WORKING
    return s


def test_draw_map_and_live_frame(tracked_port_system, tmp_path):
    from orb_slam_tpu_torch.io.viz import draw_live_frame, draw_map

    s = tracked_port_system
    p = str(tmp_path / "map.png")
    draw_map(s, p)
    assert os.path.getsize(p) > 1000
    img = np.zeros((s.cfg.camera.height, s.cfg.camera.width), np.float32)
    f = str(tmp_path / "frame.png")
    out = draw_live_frame(s, torch.from_numpy(img), f)
    assert out.shape == (s.cfg.camera.height + 18, s.cfg.camera.width, 3)
    assert os.path.getsize(f) > 0
    green = (out[..., 1] == 255) & (out[..., 0] == 0)
    assert green.sum() > 0                     # tracked keypoints drawn


def test_pgm_reader_matches_pil(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53)).astype(np.float32)
    path = str(tmp_path / "a.pgm")
    tds.write_pgm(path, img)
    ours = tds.read_pgm(path)
    np.testing.assert_array_equal(ours, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(ours, img.astype(np.uint8))
    # a header with a comment, written by PIL
    Image.fromarray(img.astype(np.uint8)).save(str(tmp_path / "b.pgm"))
    raw = open(str(tmp_path / "b.pgm"), "rb").read()
    with open(str(tmp_path / "c.pgm"), "wb") as f:
        f.write(raw[:3] + b"# a comment\n" + raw[3:])
    np.testing.assert_array_equal(tds.read_pgm(str(tmp_path / "c.pgm")), ours)


def test_load_gray_without_cv2_or_pil(tmp_path, monkeypatch):
    """Without cv2 and PIL a PGM is read with numpy; another format raises
    and names both packages."""
    img = np.arange(12 * 9, dtype=np.float32).reshape(12, 9)
    tds.write_pgm(str(tmp_path / "a.pgm"), img)
    with_libs = tds._load_gray(str(tmp_path / "a.pgm"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = tds._load_gray(str(tmp_path / "a.pgm"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, with_libs)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        tds._load_gray(str(tmp_path / "a.png"))


def test_load_gray_reads_binary_pgm_itself(tmp_path, monkeypatch):
    """A binary PGM is read with numpy even where PIL is installed (PIL is
    not imported); an ASCII PGM goes to cv2 or PIL, and raises without
    both."""
    pytest.importorskip("PIL")
    img = np.arange(7 * 5, dtype=np.float32).reshape(7, 5)
    tds.write_pgm(str(tmp_path / "a.pgm"), img)
    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    np.testing.assert_array_equal(tds._load_gray(str(tmp_path / "a.pgm")), img)
    assert "PIL" not in sys.modules
    (tmp_path / "b.pgm").write_text("P2\n3 2\n255\n0 10 20\n30 40 255\n")
    np.testing.assert_array_equal(tds._load_gray(str(tmp_path / "b.pgm")),
                                  [[0, 10, 20], [30, 40, 255]])
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        tds._load_gray(str(tmp_path / "b.pgm"))


def test_image_dir_dataset_and_prefetch(tmp_path):
    for i in range(5):
        tds.write_pgm(str(tmp_path / f"{i:03d}.pgm"), np.full((4, 6), 10 * i))
    (tmp_path / "notes.txt").write_text("x")
    ds = tds.open_dataset(str(tmp_path))
    assert len(ds) == 5
    items = list(tds.PrefetchIterator(ds, depth=2))
    assert [ts for ts, _ in items] == [i / 30.0 for i in range(5)]
    assert [float(img[0, 0]) for _, img in items] == [0.0, 10.0, 20.0, 30.0, 40.0]
    with pytest.raises(ValueError):
        tds.open_dataset(str(tmp_path / "notes.txt"))


def test_stage_timer_and_trace(tmp_path):
    from orb_slam_tpu_torch.utils.timing import StageTimer, trace_to

    t = StageTimer()
    for _ in range(3):
        with t.stage("a", result=torch.ones(3)):
            torch.ones(4).sum()
    t.record("b", 0.5)
    sm = t.summary()
    assert sm["a"]["count"] == 3 and sm["b"]["mean_ms"] == 500.0
    assert "a" in str(t)
    assert len(t.times["a"]) == 3 and t.times["b"] == [0.5]
    # SLAMSystem's stage hook: the timer called with a stage name
    times = {}
    hook = StageTimer(times=times)
    for _ in range(2):
        with hook("c"):
            torch.ones(4).sum()
    assert len(times["c"]) == 2 and hook.counts["c"] == 2
    with trace_to(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert json.load(open(str(tmp_path / "trace" / "trace.json")))


def test_dbg_is_silent_without_slam_debug(capsys, monkeypatch):
    from orb_slam_tpu_torch.utils import log

    monkeypatch.setattr(log, "DEBUG", False)
    log.dbg("hidden")
    log.info("shown")
    err = capsys.readouterr().err
    assert "hidden" not in err and "[slam] shown" in err
    monkeypatch.setattr(log, "DEBUG", True)
    log.dbg("now")
    assert "[slam] now" in capsys.readouterr().err
