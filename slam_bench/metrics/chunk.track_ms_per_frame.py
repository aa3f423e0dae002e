"""chunk.track_ms_per_frame: host ms of the program's `chunk.track` spans
(chunk_track_step on one frame of the fused chunk, pipeline/chunk.py; a
span never waits for the card) per frame the chunks extracted (one
`chunk.track` each), over the traced run's window, from the window's
stage times as chunk.extract_ms_per_frame reads them."""


def read(r):
    times = r.spans.get("stages", {}).get("chunk.track")
    return 1e3 * sum(times) / len(times) if times else None
