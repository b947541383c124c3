"""Blocking downloads a frame (`PendingHost.wait` in the program's
utils/transfer.py, counted on the calling thread): the counter deltas that
each traced `frame` span carries, per frame."""
from slambench.core import program


def read(run):
    return program.frame_attr_per_frame(run, "syncs")
