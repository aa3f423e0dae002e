"""local_ba.ms_per_kf: ms of local bundle adjustment (solvers/local_ba.py,
its two phases with their outlier updates) per keyframe integration, from
the program's stage hook."""

from slam_bench.metrics_common import stage_ms_per_kf


def read(r):
    return stage_ms_per_kf(r, ("BA phase 1", "BA phase 2"))
