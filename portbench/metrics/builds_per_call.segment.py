"""Mean number of things a call builds again (checkpoint reads, U-Net
replicas, pipelines, chunked-forward programs: the program's counters)
over the traced tail's calls."""
from harness.spans import builds_per_call


def read(run):
    return builds_per_call(run)
