"""chunk.replay_ms_per_frame: host ms of the self time of the program's
`chunk.replay` spans (SLAMSystem._apply_chunk: its reads of the chunk's
results, the trajectory, velocity and visibility counters and the
keyframe policy) per frame the chunks used, over the traced run's window.
The self time leaves out the replay's only two children, a keyframe's
`chunk.keyframe` and a weak frame's `chunk.retrack`; frames used are
counted as chunk.extracted_per_frame counts them. Read from the window's
stage times, where the program's stage hook puts each span's seconds; a
program without the spans gives none."""


def read(r):
    times = r.spans.get("stages", {})
    replay = times.get("chunk.replay")
    used = r.frames - len(times.get("frame.single", []))
    if not replay or used <= 0:
        return None
    children = sum(times.get("chunk.keyframe", [])) + sum(times.get("chunk.retrack", []))
    return 1e3 * (sum(replay) - children) / used
