"""Parallelism over several devices and several hosts.

The port of ``iterseg_tpu/parallel``: ``mesh`` (a named device grid, the
data-parallel train step and chunk-batch inference over its ``data`` axis)
and ``multihost`` (frames round-robined over processes joined by
``torch.distributed``, one shared output zarr, metric rows gathered).
"""
