"""Arithmetic shared by the per-layer metric readers of metrics/."""


def stage_ms_per_kf(r, stages):
    """ms of the program's stage-hook stages `stages`, summed over the
    traced run's window, per keyframe integration in it."""
    n = len(r.spans.get("integrate_s", []))
    if not n:
        return None
    times = r.spans["stages"]
    return 1e3 * sum(sum(times.get(s, [])) for s in stages) / n
