"""Mean seconds a frame spends in the exact host flood (the program's
``flood`` spans, a worker thread's included) over the traced tail's
frames."""
from harness.spans import per_frame


def read(run):
    return per_frame(run, "flood")
