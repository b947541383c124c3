"""Host ms a frame in the program's `frame.wait_workers` span: the entry
waiting for the mapping and loop workers to finish their keyframe events
before it reads the map, over the traced frames."""
from slambench.core import program


def read(run):
    return program.span_ms_per_frame(run, "frame.wait_workers")
