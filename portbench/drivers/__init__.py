"""The drivers: what a cell runs, one module a ``driver`` name of the traffic mixes."""
