"""mapping_kernels.triangulation_ms_per_kf: ms of local mapping's
triangulation and insertion stage (pipeline/mapping_kernels.py
triangulate_new_points and insert_new_points over every neighbour) per
keyframe integration, from the program's stage hook."""

from slam_bench.metrics_common import stage_ms_per_kf


def read(r):
    return stage_ms_per_kf(r, ("triangulation+insertion",))
