"""mapping_kernels.fuse_ms_per_kf: ms of local mapping's fuse stage
(pipeline/mapping_kernels.py fuse_into_keyframe, both ways, over every
neighbour) per keyframe integration, from the program's stage hook."""

from slam_bench.metrics_common import stage_ms_per_kf


def read(r):
    return stage_ms_per_kf(r, ("fuse",))
