"""Mean seconds a frame spends in the program's ``dispatch`` spans (the
frame's preparation, uploads and the device program's enqueue) over the
traced tail's frames."""
from harness.spans import per_frame


def read(run):
    return per_frame(run, "dispatch")
