"""K2_roofline: kernel K2 (the pose-only Gauss-Newton chain,
csrc/pose_gn.cu) as a share of its roofline, in %: the least time its
tracking call's rows and iterations allow, over the mean device time of
its launches in the traced episode. K2 is bound by its chain's latency,
so this share stays far under 1%."""

from slam_bench import roofline


def read(r):
    times = r.trace.kernel_launches("pose_gn_kernel") if r.trace else []
    if not times:
        return None
    rows = roofline.k2_rows(r.config["settings"]["ORBextractor.nFeatures"],
                            r.cfg.p_local)
    return roofline.roofline_pct(roofline.k2_work(rows), sum(times) / len(times))
