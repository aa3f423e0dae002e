"""device.launches_per_frame: work items (kernels, copies, fills) the
card ran in the traced episode, per frame handed over."""


def read(r):
    if r.trace is None or not r.trace_frames:
        return None
    return r.trace.work_items() / r.trace_frames
