"""mapping.keyframes_per_100_frames: keyframe integrations per 100
frames handed over in the traced run's window."""


def read(r):
    if "integrate_s" not in r.spans or not r.frames:
        return None
    return 100.0 * len(r.spans["integrate_s"]) / r.frames
