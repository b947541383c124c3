"""Share of the time inside the frames' calls in which no operation ran on
the device: 1 - (union of device operations inside each call) / (sum of the
calls' lengths), in %, over the traced part of the window."""
from slambench.core import readers


def read(run):
    return readers.idle_in_frames_pct(run)
