"""KB (1,000 bytes) copied host to device a frame by the program's counted
uploads (utils/transfer.py: `to_device`'s packed copies and `upload`): the
counter deltas that each traced `frame` span carries, per frame."""
from slambench.core import program


def read(run):
    return program.frame_attr_per_frame(run, "upload_bytes", 1e-3)
