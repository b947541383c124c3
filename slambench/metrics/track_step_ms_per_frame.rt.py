"""Host ms a frame inside the tracking step (`Tracker.process_frame`: the
fused motion + local-map step with its matching, selection and pose LM, and
the keyframe decision), over every frame of the window."""
from slambench.core import readers


def read(run):
    return readers.span_ms_per_frame(run, "slambench.track_step")
