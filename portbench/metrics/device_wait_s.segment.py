"""Mean seconds a frame's host blocks at its first read of device outputs
(the program's ``device_wait`` span): the device work the host did not
hide, over the traced tail's frames."""
from harness.spans import per_frame


def read(run):
    return per_frame(run, "device_wait")
