"""device.idle_pct: share of the traced episode's span in which no
kernel, copy or fill ran on the card, in %."""


def read(r):
    return r.trace.idle_pct() if r.trace is not None else None
