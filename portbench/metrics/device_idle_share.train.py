"""Percent of the traced train steps in which the device ran nothing."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
