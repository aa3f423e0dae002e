"""The port's AsyncSLAMSystem closes the drifted oracle loop of
tests/test_torch_loop_e2e.py on the CPU, with its loop thread live, and
its map equals the sequential system's.

The run: `oracle_loop_run` through AsyncSLAMSystem, drained after every
frame (`finish()`), its drift injected in a request_stop / release
window. The loop thread detects the revisit, parks the mapper for the
correction (the park window, the correction as the only map writer,
`_refresh_local_mask` from the loop thread, the release that drops
queued keyframes), and the tracker goes on against the corrected map.
The drain makes the run deterministic, so the reference is the
sequential SLAMSystem on the same frames with one difference, the one
the async system documents: its tracker keeps its own pose after an
integration instead of adopting the BA-refined keyframe pose
(`_publish_mapped_pose`). Held: one loop closed in each, the keyframe ATE
lowered by the correction, and the map, the host lists and the counters
equal bit for bit just after the correction and at the end.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.pipeline.async_system import AsyncSLAMSystem
from tests.test_torch_loop_e2e import oracle_loop_run
from tests.test_torch_system_map import _two_threads  # noqa: F401


class KeepsOwnPose(tsys.SLAMSystem):
    """The sequential system with the async tracker's pose rule."""

    def _publish_mapped_pose(self, new_kf: int):
        pass


def _snapshot(s):
    return ({f.name: getattr(s.map, f.name).clone() for f in dataclasses.fields(s.map)},
            list(s.free_kf), list(s.free_pt), s.kf_order.copy(), s.pt_forward.copy())


def _recording(make_system, after):
    """`make_system` whose loop closer's `correct` appends a snapshot of
    the system just after each correction to `after`."""
    def make(cfg, device):
        s = make_system(cfg, device=device)
        setup = s._setup_place_recognition

        def setup_recorded(*args):
            setup(*args)
            correct = s.loop_closer.correct

            def recorded(system, new_kf, cand, S12):
                ok = correct(system, new_kf, cand, S12)
                after.append(_snapshot(system))
                return ok

            s.loop_closer.correct = recorded

        s._setup_place_recognition = setup_recorded
        return s
    return make


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, make in (("async", AsyncSLAMSystem), ("sequential", KeepsOwnPose)):
        after = []
        out[name] = oracle_loop_run(_recording(make, after)) + (after,)
    return out


def test_async_closes_the_drifted_oracle_loop(runs):
    s, tracked, n, ates, after = runs["async"]
    assert s._mapper_error is None and s._loop_error is None
    assert not s._thread.is_alive() and not s._loop_thread.is_alive()
    assert tracked > 0.6 * n, (tracked, n)
    assert s.n_loops_closed == 1 and len(ates) == 1 and len(after) == 1
    before, after_ate = ates[0]
    assert after_ate < before, (before, after_ate)
    m = s.map
    assert torch.isfinite(m.kf_pose[m.kf_valid]).all()
    assert torch.isfinite(m.pt_pos[m.pt_valid]).all()
    assert (m.loop_edges >= 0).any()


@pytest.mark.parametrize("when", ["after the correction", "at the end"])
def test_async_loop_map_equals_sequential(runs, when):
    a, q = runs["async"], runs["sequential"]
    assert a[0].n_loops_closed == q[0].n_loops_closed == 1
    assert a[1] == q[1] and a[3] == q[3]
    snaps = (a[4][0], q[4][0]) if when == "after the correction" else (
        _snapshot(a[0]), _snapshot(q[0]))
    (ma, *la), (mq, *lq) = snaps
    for name in ma:
        np.testing.assert_array_equal(ma[name].numpy(), mq[name].numpy(), name)
    assert la[0] == lq[0] and la[1] == lq[1]
    np.testing.assert_array_equal(la[2], lq[2])
    np.testing.assert_array_equal(la[3], lq[3])
