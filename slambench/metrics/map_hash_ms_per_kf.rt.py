"""Host ms a keyframe event in the mapping worker's `map.hash` span (its
points inserted into the multi-index hash's tables, then the active tables
selected again): the spans that end inside the traced part of the window,
summed, over their number. Nothing is read where there are none."""
from slambench.core import program


def read(run):
    t = run.trace
    spans = program.program_spans()
    if t is None or not spans:
        return None
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in spans
          if s.name == "map.hash" and t.t0_ns <= s.end_ns <= t.t1_ns]
    return sum(ms) / len(ms) if ms else None
