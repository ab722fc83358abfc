"""Milliseconds a train step: the window's seconds over its steps."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["window_s"] / run["steps"] * 1e3
