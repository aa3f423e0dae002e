"""K1_roofline: kernel K1 (FAST score, 3x3 maximum and border mask,
csrc/fast_score_nms.cu) as a share of its roofline, in %: the least time
the level canvas of the cell's pyramid allows, over the mean device time
of its launches in the traced episode."""

from slam_bench import roofline


def read(r):
    times = r.trace.kernel_launches("fast_score_nms_kernel") if r.trace else []
    if not times:
        return None
    st = r.config["settings"]
    shapes = roofline.pyramid_shapes(st["Camera.height"], st["Camera.width"],
                                     st["ORBextractor.nLevels"],
                                     st["ORBextractor.scaleFactor"])
    return roofline.roofline_pct(roofline.k1_work(shapes), sum(times) / len(times))
