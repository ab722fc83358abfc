"""Voxels segmented a second: every voxel of every frame of the window's
calls, over the window (first call's start to last call's return)."""


def read(run):
    if run["kind"] != "segment":
        return None
    done = sum(c[2] for c in run["calls"] if c[3])
    return done / run["window_s"]
