"""Host ms a frame in the program's `track.dispatch` span: the tracking
thread's enqueue of the fused motion + local-map step (`fused_track`, with
its selection and pose LM launches), over the traced frames."""
from slambench.core import program


def read(run):
    return program.span_ms_per_frame(run, "track.dispatch")
