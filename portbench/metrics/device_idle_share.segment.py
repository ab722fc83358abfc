"""Percent of the traced tail's window in which the device ran nothing,
averaged over the cell's cards."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "segment" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
