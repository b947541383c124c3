"""Kernel 3 (csrc/greedy_select.cu) against its roofline: the summed least
time of the traced calls (from P, D, the picks and the logdets each call's
lazier sample scored; slambench/core/roofline.py) over the summed device
time of its kernels, in %."""
from slambench.core import readers, roofline


def read(run):
    return readers.roofline_share(run, "slambench.greedy_select", "greedy_select_kernel",
                                  roofline.greedy_select_least_s)
