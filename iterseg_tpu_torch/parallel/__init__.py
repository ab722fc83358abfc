"""Parallelism over several devices and several hosts.

The port of ``iterseg_tpu/parallel``: ``mesh`` (a named device grid, and the
train step and chunk-batch inference over its ``data`` and ``space`` axes)
and ``multihost`` (frames round-robined over processes joined by
``torch.distributed``, one shared output zarr, metric rows gathered).
"""
