"""Launch calls (cudaLaunchKernel and kin) the tracking thread makes inside
a frame's call, outside its wait for the mapping and loop workers, per
frame; from the profiler's trace of the traced part of the window."""
from slambench.core import readers


def read(run):
    return readers.launches_per_frame(run)
