"""Kernel 2 (csrc/pose_lm.cu) against its roofline: the summed least time of
the traced calls (their own N and rounds x iters; slambench/core/roofline.py)
over the summed device time of its kernels, in %."""
from slambench.core import readers, roofline


def read(run):
    return readers.roofline_share(run, "slambench.pose_lm", "pose_lm_kernel",
                                  lambda c: roofline.pose_lm_least_s(c["n"], c["rounds"],
                                                                     c["iters"]))
