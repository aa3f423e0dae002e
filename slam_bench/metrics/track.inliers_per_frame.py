"""track.inliers_per_frame: inlier matches per tracked frame, over the
traced run's window: the program's counters `track.inliers` (one value
per tracked frame, the chunk's replay and `_track` alike) over
`track.frames` (one per tracked frame). Its margin over the
configuration's `min_track_inliers` (30) is how near tracking comes to
re-entering a weak frame through `_track` or losing the camera. The
program's stage hook keeps each counter's values in the window's stage
times under the counter's name; a program without the counters gives
none."""


def read(r):
    times = r.spans.get("stages", {})
    inliers, frames = times.get("track.inliers"), times.get("track.frames")
    if not inliers or not frames:
        return None
    return sum(inliers) / sum(frames)
