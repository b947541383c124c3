"""Host ms a frame in the program's `track.fetch` spans: the tracking thread
blocked on the frame's download (`Tracker._fetch`), which waits for the
device's backlog, the frontend's enqueued work included, over the traced
frames."""
from slambench.core import program


def read(run):
    return program.span_ms_per_frame(run, "track.fetch")
