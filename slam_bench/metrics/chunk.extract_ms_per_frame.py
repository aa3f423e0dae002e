"""chunk.extract_ms_per_frame: host ms of the program's `chunk.extract`
spans (the extractor and the undistortion of one frame of the fused
chunk, pipeline/chunk.py; a span never waits for the card, so this is the
host's time to issue the frame's extraction) per frame the chunks
extracted, over the traced run's window. The program's stage hook puts
each span's seconds in the window's stage times under its name, one
`chunk.extract` per frame extracted; a program without the span gives
none."""


def read(r):
    times = r.spans.get("stages", {}).get("chunk.extract")
    return 1e3 * sum(times) / len(times) if times else None
