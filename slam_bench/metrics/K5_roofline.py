"""K5_roofline: kernel K5 (the keypoint selection, csrc/keypoint_select.cu)
as a share of its roofline, in %: the least time the cell's shapes allow
(the level pixels read once as f32, and the outputs xy, score and valid,
L x Qmax x 13 bytes, written once), over K5's device time per selection
in the traced episode: the seconds of every launch whose kernel name
holds "keypoint_select", summed, per launch of K1 (one selection per
extraction). K5 is bound by its chain's latency, so this share stays
far under 100%."""

from slam_bench import roofline
from slam_bench.reference.orb import level_quotas


def read(r):
    if r.trace is None:
        return None
    k5 = r.trace.kernel_launches("keypoint_select")
    k1 = r.trace.kernel_launches("fast_score_nms_kernel")
    if not k5 or not k1:
        return None
    st = r.config["settings"]
    n, levels, scale = (st["ORBextractor.nFeatures"], st["ORBextractor.nLevels"],
                        st["ORBextractor.scaleFactor"])
    shapes = roofline.pyramid_shapes(st["Camera.height"], st["Camera.width"],
                                     levels, scale)
    n_bytes = (4 * sum(h * w for h, w in shapes)
               + len(shapes) * max(level_quotas(n, levels, scale)) * 13)
    return roofline.roofline_pct((n_bytes, 0), sum(k5) / len(k1))
