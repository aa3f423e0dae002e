"""The readers of the program's own spans, which the program's stage hook
puts in the traced window's stage times (`Readings.spans["stages"]`)
beside local mapping's stages: on hand-built Readings; against the
program's own counters and self times on a small run; the readers that
were there before reading the same with and without the spans; and a
tiny traced run."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.profile_paths import start_working
from orb_slam_tpu_torch.slam_map.map_state import MapConfig
from orb_slam_tpu_torch.utils.timing import StageTimer
from slam_bench import harness
from slam_bench.harness import ROOT, Readings, reader
from slam_bench.tests import tiny
from slam_bench.trace import Trace

NEW = ("chunk.extract_ms_per_frame", "chunk.track_ms_per_frame",
       "chunk.replay_ms_per_frame", "chunk.extracted_per_frame")


def program_times():
    """Stage times of a window of 16 frames: two chunks of 8, the first
    stopped at its 6th frame by a keyframe, the second run to its end,
    and two frames through `process`; 0.5 ms of extraction and 1 ms of
    tracking per frame extracted, replays of 2 ms and 100 ms, the second
    holding a 97 ms keyframe."""
    return {"chunk.extract": [0.0005] * 16, "chunk.track": [0.001] * 16,
            "chunk.replay": [0.002, 0.1], "chunk.keyframe": [0.097],
            "frame.single": [0.05, 0.05]}


def test_the_program_readers_on_hand_made_times():
    r = Readings(spans={"stages": program_times()}, frames=16)
    assert reader(ROOT, "chunk.extract_ms_per_frame")(r) == pytest.approx(0.5)
    assert reader(ROOT, "chunk.track_ms_per_frame")(r) == pytest.approx(1.0)
    # self time 5 ms over the 14 frames the chunks used
    assert reader(ROOT, "chunk.replay_ms_per_frame")(r) == pytest.approx(5.0 / 14)
    assert reader(ROOT, "chunk.extracted_per_frame")(r) == pytest.approx(16 / 14)


@pytest.mark.parametrize("spans", [{}, {"stages": {}},
                                   {"stages": {"fuse": [0.07], "BA phase 1": [0.05]}}])
def test_the_program_readers_read_nothing_without_the_programs_spans(spans):
    # no stage times, none recorded, and a program whose hook times its
    # stages alone
    r = Readings(spans=spans, frames=16)
    for name in NEW:
        assert reader(ROOT, name)(r) is None


def small_run():
    """(stage timer, frames) of process_batch on the CPU over 12 frames at
    320x240 in calls of 6, chunks of 4, from a map seeded with two
    keyframes, under the stage hook as the harness installs it."""
    W, H, f = 320, 240, 250.0
    scene = SyntheticScene(n_points=800, width=W, height=H, fx=f, fy=f, cx=W / 2,
                           cy=H / 2)
    poses = lateral_trajectory(14, step=0.04)
    imgs = [scene.render_image(p) for p in poses]
    cfg = tsys.SlamConfig(camera=CameraModel(f, f, W / 2, H / 2, width=W, height=H),
                          orb=ORBConfig(n_features=300, n_levels=4),
                          map=MapConfig(max_keyframes=16, max_points=2048,
                                        n_features=300, n_levels=4),
                          track_chunk_size=4)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        s = tsys.SLAMSystem(cfg, device="cpu")
        start_working(s, scene, poses, torch.from_numpy(np.stack(imgs)))
        timer = s._stage_timer = StageTimer(times={})
        frames = imgs[2:]
        for i in range(0, len(frames), 6):
            s.process_batch(frames[i:i + 6])
    finally:
        torch.set_num_threads(n)
    return timer, len(frames)


def test_the_readers_agree_with_the_programs_counters_and_self_times():
    t, frames = small_run()
    c = t.counters
    extracted, used = sum(c["chunk.frames_extracted"]), sum(c["chunk.frames_used"])
    assert len(c.get("chunk.exit_keyframe", [])) >= 1
    r = Readings(spans={"stages": t.times}, frames=frames)
    assert reader(ROOT, "chunk.extracted_per_frame")(r) == extracted / used
    assert reader(ROOT, "chunk.extract_ms_per_frame")(r) == pytest.approx(
        1e3 * t.totals["chunk.extract"] / extracted)
    assert reader(ROOT, "chunk.track_ms_per_frame")(r) == pytest.approx(
        1e3 * t.totals["chunk.track"] / extracted)
    assert reader(ROOT, "chunk.replay_ms_per_frame")(r) == pytest.approx(
        1e3 * t.self_totals["chunk.replay"] / used, abs=1e-9)


def full_readings(stages):
    """Readings as a traced run on a card leaves them, for every reader."""
    with open(ROOT / "configs" / "tum-fast.json") as f:
        config = json.load(f)
    dev = [("fast_score_nms_kernel", "kernel", 0.1, 0.10002),
           ("pose_gn_kernel", "kernel", 0.2, 0.2002),
           ("keypoint_select_cells_kernel", "kernel", 0.25, 0.25001),
           ("Memcpy HtoD", "gpu_memcpy", 0.3, 0.31)]
    spans = dict(chunk_s=[0.2, 0.19], chunk_frames=[8, 8], integrate_s=[0.22, 0.24],
                 stages=stages, neighbors=[6, 7], ba_cams=[29, 30])
    return Readings(config=config, traffic={}, cfg=SimpleNamespace(p_local=4096),
                    setup_s=44.0, window_s=30.0, latencies=[0.06] * 16, frames=16,
                    failed=0, episodes=1, spans=spans,
                    window_trace=Trace(dev, [], (0.0, 1.0)),
                    trace=Trace(dev, [("chunk", 0.0, 0.5)], (0.0, 1.0)),
                    trace_frames=16)


def test_the_readers_before_read_the_same_beside_the_programs_spans():
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]
             if m["name"] not in NEW]
    assert len(names) == 16
    stages = {"fuse": [0.07, 0.08], "triangulation+insertion": [0.03, 0.035],
              "BA phase 1": [0.05, 0.05], "BA phase 2": [0.04, 0.045]}
    without, with_ = full_readings(stages), full_readings({**stages, **program_times()})
    for name in names:
        read = reader(ROOT, name)
        a, b = read(without), read(with_)
        assert a is not None and a == b, name


def test_a_traced_run_reads_the_programs_spans(tmp_path):
    # 8 frames per call over 8 cm/frame: chunks that stop at keyframes
    res = tiny.run(tmp_path, "tum-fast.creep-batch", trace=True, step=0.08)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    assert m["chunk.extracted_per_frame"] >= 1.0
    assert {"chunk.ms_per_frame", "local_ba.ms_per_kf"} <= set(m)
