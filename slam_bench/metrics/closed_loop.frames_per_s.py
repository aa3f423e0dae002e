"""closed_loop.frames_per_s: frames handed over in the traced run's
window, over the window's length; the window ends with the call that
crosses `--seconds`, so every frame counted had its pose returned inside
it, keyframe integrations and episode restores included. The traced
run's window is not profiled; its host clocks synchronize the card
around each chunk and integration."""

from slam_bench import stats


def read(r):
    return stats.rate(r.frames, r.window_s)
