"""local_ba.cams_per_kf: keyframes in each local bundle adjustment, the
optimised ones (SLAMSystem._local_ba_sets) and the fixed ones that
observe its points, mean over the keyframe integrations of the traced
run's window."""


def read(r):
    n = r.spans.get("ba_cams", [])
    return sum(n) / len(n) if n else None
