"""Host ms a frame inside System's frontend (extraction, and stereo matching
or depth lookup): the benchmark's span around `_frontend_stereo_impl` /
`_frontend_mono_impl`, over every frame of the window."""
from slambench.core import readers


def read(run):
    return readers.span_ms_per_frame(run, "slambench.frontend")
