"""The 90th percentile of the window's call seconds (linear between
ranks); a failed call counts as infinitely slow. A per-layer reading
beside the rate: between processes it spreads too widely for a bound."""
import math

import numpy as np


def read(run):
    if run["kind"] != "segment":
        return None
    s = [c[1] - c[0] if c[3] else math.inf for c in run["calls"]]
    return float(np.percentile(s, 90))
