"""Mean seconds a call spends in its ``entry`` span (the program's span
from the public entry's start to its first frame: configuration, the
checkpoint read, the output store) over the traced tail's calls."""
from harness.spans import per_call


def read(run):
    return per_call(run, "entry")
