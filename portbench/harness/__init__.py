"""The harness: drivers, trace reading and the comparison."""
