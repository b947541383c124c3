"""Seconds from the process's start to the window's first frame: imports,
rendering, the System's construction (the kernels' load or build, the loop
closer's warm-up) and the warm-up frames."""


def read(run):
    return run.setup_s
