"""Replays of the frontend's captured CUDA graph a frame (the program's
`frontend.graph_replays` counter, utils/cuda_graph.py): the counter deltas
that each traced `frame` span carries, per frame. A program without the
counter gives nothing."""
from slambench.core import program


def read(run):
    return program.frame_attr_per_frame(run, "graph_replays")
