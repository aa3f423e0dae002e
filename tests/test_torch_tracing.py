"""The port's tracer (utils/timing.py StageTimer) and the spans and
counters SLAMSystem gives it.

StageTimer alone: spans nest under the innermost one open on their own
thread, with their parent's index and frame id in the records and self
times that leave out the children; `span()` never synchronizes, even in
a synchronizing timer; SLAMSystem falls back to the hook itself where it
has no `span` (torch.profiler.record_function). Then a small
`process_batch` run on the CPU (320x240 frames, 300 features, 4 levels,
chunks of 4 from a map seeded with two keyframes), with and without a
timer: the chunk counters add up to the frames handed over, the tracking
counters to the frames given a pose (kept in the timer's `times` too),
the poses and the map are the same bit for bit, the timer adds no read
of a tensor's value and the system no attribute a benchmark snapshot
would copy.
"""

import threading

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
from slam_bench import seeding

# Tensor methods that hand a tensor's value to the host
HOST_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
              "__float__", "__index__", "__array__")


def test_spans_nest_with_parents_frames_and_self_times():
    t = StageTimer(sync=False, keep_spans=True)
    with t.span("outer", frame=7):
        with t.span("inner"):
            with t.span("leaf", frame=9):
                pass
        with t.stage("stage"):
            pass
    with t.span("next"):
        pass
    names = [r[0] for r in t.spans]
    assert names == ["outer", "inner", "leaf", "stage", "next"]
    parents = [r[1] for r in t.spans]
    assert parents == [None, 0, 1, 0, None]
    frames = [r[2] for r in t.spans]
    assert frames == [7, 7, 9, 7, None]
    for name, parent, _, thread, a, b in t.spans:
        assert a <= b and thread == threading.get_ident()
        if parent is not None:
            pa, pb = t.spans[parent][4:]
            assert pa <= a and b <= pb
    assert t.self_totals["outer"] == pytest.approx(
        t.totals["outer"] - t.totals["inner"] - t.totals["stage"], abs=1e-12)
    assert t.self_totals["inner"] == pytest.approx(
        t.totals["inner"] - t.totals["leaf"], abs=1e-12)
    assert t.self_totals["leaf"] == t.totals["leaf"]
    assert t.stage_names == {"stage"}
    sm = t.summary()
    assert sm["outer"]["count"] == 1 and "self_s" in sm["outer"]
    assert len(t.times["leaf"]) == 1
    t.count("n", 3)
    t.count("n")
    assert t.counters == {"n": [3, 1]}


def test_each_thread_nests_under_its_own_spans():
    t = StageTimer(sync=False, keep_spans=True)
    both_open = threading.Barrier(2, timeout=10)

    def work(k):
        with t.span(f"outer{k}", frame=k):
            both_open.wait()
            with t.span(f"inner{k}"):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    by_name = {r[0]: (i, r) for i, r in enumerate(t.spans)}
    for k in (0, 1):
        i, outer = by_name[f"outer{k}"]
        _, inner = by_name[f"inner{k}"]
        assert outer[1] is None and inner[1] == i
        assert inner[2] == k and inner[3] == outer[3]
    assert by_name["outer0"][1][3] != by_name["outer1"][1][3]


def test_aggregates_alone_without_keep_spans():
    t = StageTimer(sync=False)
    for _ in range(3):
        with t.span("a"):
            with t.span("b"):
                pass
    assert t.spans is None and t.counts["a"] == 3 and len(t.times["b"]) == 3
    assert t.self_totals["a"] <= t.totals["a"]


def test_a_span_never_synchronizes(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("synchronized")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    t = StageTimer(sync=True, keep_spans=True)
    with t.span("chunk.extract"):
        torch.ones(4).sum()
    assert t.counts["chunk.extract"] == 1
    # the same timer's stages do synchronize, so the patch bites
    with pytest.raises(AssertionError, match="synchronized"):
        with t.stage("fuse"):
            pass


def test_system_span_falls_back_to_a_plain_hook():
    s = tsys.SLAMSystem.__new__(tsys.SLAMSystem)
    s._stage_timer = None
    assert s._span("chunk.replay", 3).__class__.__name__ == "nullcontext"
    s._count("chunk.frames_used", 4)
    s._stage_timer = torch.profiler.record_function
    ctx = s._span("chunk.replay", 3)
    assert isinstance(ctx, torch.profiler.record_function)
    with ctx:
        pass
    s._count("chunk.frames_used", 4)   # a hook without counters: nothing
    t = s._stage_timer = StageTimer(sync=False)
    with s._span("chunk.replay", 3):
        pass
    s._count("chunk.frames_used", 4)
    assert t.counts["chunk.replay"] == 1
    assert t.counters == {"chunk.frames_used": [4]}


def small_system():
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
    s = tsys.SLAMSystem(cfg, device="cpu")
    start_working(s, scene, poses, torch.from_numpy(np.stack(imgs)))
    return s, imgs[2:]


def counted_run(monkeypatch, s, imgs):
    """process_batch over `imgs` in calls of 6 frames, counting each
    Tensor method of HOST_READS called."""
    reads = dict.fromkeys(HOST_READS, 0)
    for name in HOST_READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _name=name, _orig=orig, **k):
            reads[_name] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    out = []
    for i in range(0, len(imgs), 6):
        out += s.process_batch(imgs[i:i + 6])
    monkeypatch.undo()
    return out, reads


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    try:
        plain, traced = small_system(), small_system()
        keys = set(seeding.snapshot(plain[0]))
        timer = traced[0]._stage_timer = StageTimer(sync=False, keep_spans=True)
        out_plain, reads_plain = counted_run(mp, *plain)
        out_traced, reads_traced = counted_run(mp, *traced)
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return dict(plain=plain[0], traced=traced[0], timer=timer, keys=keys,
                frames=len(plain[1]), out=(out_plain, out_traced),
                reads=(reads_plain, reads_traced))


def test_chunk_counters_add_up(runs):
    c = runs["timer"].counters
    used, extracted = c["chunk.frames_used"], c["chunk.frames_extracted"]
    assert len(used) == len(extracted) >= 2
    assert sum(used) + len(c.get("frames.single", [])) == runs["frames"]
    assert sum(extracted) >= sum(used)
    assert all(0 < u <= e for u, e in zip(used, extracted))
    exits = [len(c.get(f"chunk.exit_{k}", [])) for k in ("keyframe", "weak", "end")]
    assert sum(exits) == len(used) and exits[0] >= 1
    t = runs["timer"]
    assert t.counts["chunk.extract"] == t.counts["chunk.track"] == sum(extracted)
    assert t.counts["chunk.replay"] == t.counts["chunk.upload"] == len(used)
    assert t.counts["frame.single"] == len(c.get("frames.single", []))
    n_kf = runs["traced"].kf_counter - 2
    assert t.counts["mapping.integrate"] == len(c["mapping.neighbors"]) == n_kf
    assert t.counts["mapping.reclaim"] == 2 * n_kf


def test_integration_spans_carry_the_keyframes_frame(runs):
    t = runs["timer"]
    recs = t.spans
    kf_frames = {r[2] for r in recs if r[0] == "mapping.integrate"}
    fids = set(runs["traced"].map.kf_frame_id[runs["traced"].map.kf_valid].tolist())
    assert kf_frames & fids
    for name, parent, frame, _, _, _ in recs:
        if name in ("fuse", "BA phase 1", "mapping.insert", "local_ba.sets"):
            assert recs[parent][0] == "mapping.integrate"
            assert frame == recs[parent][2]
        if name == "chunk.extract":
            assert parent is None
    # replay self time leaves out the integrations nested in it
    assert t.self_totals["chunk.replay"] < t.totals["chunk.replay"]


def test_the_replays_only_children_are_its_keyframe_and_retrack(runs):
    # the benchmark reads the replay's self time as its total less these
    t = runs["timer"]
    recs = t.spans
    children = {r[0] for r in recs
                if r[1] is not None and recs[r[1]][0] == "chunk.replay"}
    assert "chunk.keyframe" in children
    assert children <= {"chunk.keyframe", "chunk.retrack"}
    assert all(recs[r[1]][0] == "chunk.replay" for r in recs
               if r[0] in ("chunk.keyframe", "chunk.retrack"))
    assert t.counts["chunk.keyframe"] == len(t.counters["chunk.exit_keyframe"])
    assert t.self_totals["chunk.replay"] == pytest.approx(
        t.totals["chunk.replay"] - t.totals["chunk.keyframe"]
        - t.totals.get("chunk.retrack", 0.0), abs=1e-9)


def test_the_timer_changes_no_pose_no_map_and_no_host_read(runs):
    a, b = runs["out"]
    assert len(a) == len(b) == runs["frames"]
    for p, q in zip(a, b):
        assert (p is None) == (q is None)
        if p is not None:
            np.testing.assert_array_equal(p, q)
    ma, mb = runs["plain"].map, runs["traced"].map
    for f in ("kf_pose", "kf_obs", "pt_pos", "pt_valid"):
        assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    assert runs["reads"][0] == runs["reads"][1]
    assert sum(runs["reads"][0].values()) > 0


def test_a_traced_system_snapshots_no_new_key(runs):
    assert set(seeding.snapshot(runs["traced"])) == runs["keys"]
    assert set(seeding.snapshot(runs["plain"])) == runs["keys"]


def test_the_track_counters_count_every_tracked_frame(runs):
    # one event per frame given a pose, chunk and single frames alike;
    # the host-read count above holds with them on
    c = runs["timer"].counters
    tracked = sum(p is not None for p in runs["out"][1])
    assert sum(c["track.frames"]) == len(c["track.inliers"]) == tracked
    assert min(c["track.inliers"]) >= runs["traced"].cfg.min_track_inliers
    assert runs["timer"].times["track.inliers"] is c["track.inliers"]
