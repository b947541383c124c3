"""Host ms a frame in the program's `track.step` span outside its
`track.dispatch` and `track.fetch` spans: the tracking step's host
bookkeeping (last-frame points, pool uploads, the association, the local
pool's gathering, the keyframe decision), over the traced frames."""
from slambench.core import program


def read(run):
    return program.span_ms_per_frame(run, "track.step", minus=("track.dispatch", "track.fetch"))
