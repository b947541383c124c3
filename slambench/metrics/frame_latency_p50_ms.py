"""Median over every frame offered in the window of the time from when the
frame was due (its timestamp at the camera's rate) to when System returned
its pose (host clock)."""
from slambench.core import readers


def read(run):
    return readers.latency_percentile_ms(run, 50)
