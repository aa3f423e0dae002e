"""mapping.integrate_ms_p50: median host ms, the card synchronized at
both ends, of one keyframe integration (SLAMSystem._integrate_keyframe)
over the traced run's window."""

import statistics


def read(r):
    t = r.spans.get("integrate_s", [])
    return 1e3 * statistics.median(t) if t else None
