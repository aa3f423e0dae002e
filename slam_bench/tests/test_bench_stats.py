"""The rate, percentile and idle arithmetic, and the roofline counts from
shapes."""

import pytest

from slam_bench import roofline, stats
from slam_bench.harness import Readings, ROOT, reader
from slam_bench.trace import Trace, _kind, from_events


def test_rate_counts_every_frame_over_the_whole_window():
    # 10 calls of 8 frames, the last one crossing the window's end
    r = Readings(frames=80, window_s=4.0, latencies=[0.05] * 80)
    assert reader(ROOT, "closed_loop.frames_per_s")(r) == pytest.approx(20.0)
    with pytest.raises(ValueError):
        stats.rate(5, 0.0)


def test_card_time_is_the_windows_busy_time_per_frame():
    # busy 3 s of a 10 s window: overlapping kernels count once, work
    # begun before the window's start only from its start
    dev = [("k", "kernel", -1.0, 0.5), ("k", "kernel", 1.0, 2.0),
           ("k", "kernel", 1.5, 2.5), ("Memcpy HtoD", "gpu_memcpy", 4.0, 5.0)]
    r = Readings(frames=50, window_s=10.0, window_trace=Trace(dev, [], (0.0, 10.0)))
    assert reader(ROOT, "card_ms_per_frame")(r) == pytest.approx(1e3 * 3.0 / 50)
    assert reader(ROOT, "card_ms_per_frame")(Readings(frames=50, window_s=10.0,
                                                      window_trace=None)) is None


def test_percentile_is_over_every_frame():
    lat = [0.07] * 95 + [0.3] * 5
    assert stats.percentile(lat, 95) == 0.07
    assert stats.percentile(lat + [0.3], 95) == 0.3
    assert stats.percentile([0.07] * 90 + [0.25] * 10, 95) == 0.25


def test_idle_union_on_a_hand_made_trace():
    dev = [("k", "kernel", 1.0, 2.0), ("k", "kernel", 1.5, 2.5),
           ("Memcpy HtoD", "gpu_memcpy", 4.0, 4.5), ("k2", "kernel", 9.5, 11.0)]
    labels = [("chunk", 0.6, 3.0), ("integrate", 3.0, 9.0), ("track", 3.5, 4.2)]
    t = Trace(dev, labels, (0.0, 10.0))
    assert t.busy_s() == pytest.approx(1.5 + 0.5 + 0.5)
    assert t.idle_pct() == pytest.approx(75.0)
    assert t.work_items() == 4
    assert t.kernel_launches("k2") == [1.5]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k", 2.0]
    idle = dict(b["idle_gaps"])
    # gaps: [0, 1) outside every label; [2.5, 4) and [4.5, 9.5), their
    # middles 3.25 and 7 inside `integrate` alone
    assert idle["other"] == pytest.approx(1.0), idle
    assert idle["integrate"] == pytest.approx(1.5 + 5.0)
    assert stats.gaps([(1, 2)], 0, 3) == [(0, 1), (2, 3)]


def test_roofline_counts_from_the_cells_shapes():
    shapes = roofline.pyramid_shapes(480, 640, 8, 1.2)
    assert shapes[0] == (480, 640) and shapes[-1] == (134, 179)
    b, ops = roofline.k1_work(shapes)
    t, by = roofline.bound_s(b, ops)
    assert by == "bytes" and t == pytest.approx(2.27e-6, rel=0.01)
    rows = roofline.k2_rows(1000, 4096)
    assert rows == 1024
    t2, by2 = roofline.bound_s(*roofline.k2_work(rows))
    assert by2 == "operations" and t2 == pytest.approx(0.025e-6, rel=0.05)
    assert roofline.roofline_pct((3.35e6, 0), 2e-6) == pytest.approx(50.0)


def test_host_labels_land_on_the_traces_clock():
    # the trace's clock runs 1000 s ahead of the host's; the marker kernel
    # starts 20 us after its launch at host time 5.0
    dev = [("k", "kernel", 1005.5, 1005.6), ("spin_kernel", "kernel", 1005.00002, 1005.00003),
           ("Memset (Device)", "gpu_memset", 1006.0, 1006.1)]
    t = from_events(sorted(dev, key=lambda d: d[2]), [("chunk", 5.4, 5.9)], (5.0, 6.5), 5.0)
    assert [d[0] for d in t.device] == ["k", "Memset (Device)"]
    assert t.span[0] == pytest.approx(1005.00002)
    assert t.window_s == pytest.approx(1.5)
    assert t.labels[0][1] == pytest.approx(1005.40002)
    assert t.busy_s() == pytest.approx(0.2)
    assert dict(t.breakdown()["idle_gaps"])["chunk"] == pytest.approx(0.4, abs=1e-4)


def test_device_event_kinds():
    assert _kind("fast_score_nms_kernel") == "kernel"
    assert _kind("Memcpy HtoD (Pageable -> Device)") == "gpu_memcpy"
    assert _kind("Memset (Device)") == "gpu_memset"
