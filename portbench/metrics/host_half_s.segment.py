"""Mean seconds a frame spends in its host half: the program's
``finalize`` span less its ``device_wait``, over the traced tail's
frames."""
from harness.spans import per_frame


def read(run):
    return per_frame(run, "finalize", less=("device_wait",))
