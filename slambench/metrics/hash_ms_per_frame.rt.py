"""Host ms a frame in the program's hashed local map: its `track.hash` spans
(the multi-index hash's query, the validity filter, the candidate budget's
update, the union with the covisibility points and the pool's cap) and its
`track.hash_scores` spans (the online table selection's score update from
the frame's matches), over the traced frames. Nothing is read where the
traced frames hold no `track.hash` span: a change that stops the hash from
running reads no gain."""
from slambench.core import program


def read(run):
    spans = program.program_spans()
    if not program.inside(program.frames(run, spans), spans, "track.hash"):
        return None
    return program.span_ms_per_frame(run, "track.hash", "track.hash_scores")
