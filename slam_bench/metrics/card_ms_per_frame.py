"""card_ms_per_frame: milliseconds of the window in which some kernel,
copy or fill ran on the card, per frame handed over in it: the card's
time a frame costs, all the window's work over all its time. Read from
the profile of the whole window that an untraced run on a card takes;
nothing without one."""


def read(r):
    tr = getattr(r, "window_trace", None)
    if tr is None or not r.frames:
        return None
    return 1e3 * tr.busy_s() / r.frames
