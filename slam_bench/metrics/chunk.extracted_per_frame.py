"""chunk.extracted_per_frame: frames the fused chunks extracted and
tracked per frame they used, over the traced run's window: a chunk stops
at its first keyframe or weak frame, and its later frames go into the
next chunk and are extracted again. 1 where nothing is redone.

Read from the window's stage times, where the program's stage hook puts
one `chunk.extract` span per frame a chunk extracted and one
`frame.single` per frame `process` took: process_batch hands every frame
to one or the other, so the chunks used the window's frames less the
`frame.single` ones (the program's counters `chunk.frames_extracted` and
`chunk.frames_used`, which the harness does not reach, hold the same
sums). A program without the spans gives none."""


def read(r):
    times = r.spans.get("stages", {})
    extracted = len(times.get("chunk.extract", []))
    used = r.frames - len(times.get("frame.single", []))
    return extracted / used if extracted and used > 0 else None
