"""chunk.ms_per_frame: host ms, the card synchronized at both ends, of
the program's fused extract-and-track chunk (SLAMSystem.
_chunk_extract_track), per frame it handled, over the traced run's
window."""


def read(r):
    frames = sum(r.spans.get("chunk_frames", []))
    return 1e3 * sum(r.spans["chunk_s"]) / frames if frames else None
