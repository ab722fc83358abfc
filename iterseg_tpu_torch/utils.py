"""Observability utilities: phase timers and device profiler traces.

The port of ``iterseg_tpu/utils.py``: a ``phase_timer`` accumulates
wall-clock per pipeline stage (the dict ``AffinityPipeline.segment(profile=
...)`` fills), and ``device_trace`` wraps ``torch.profiler`` in place of
``jax.profiler``, writing a Chrome trace (``chrome://tracing``, Perfetto).
There is no XLA compilation cache to enable, so ``enable_compilation_cache``
is not ported.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

__all__ = ["phase_timer", "device_trace", "Stopwatch"]


class Stopwatch:
    """Accumulating named phase timer."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self):
        total = sum(self.times.values())
        lines = [f"total {total:.3f}s"]
        for k, v in sorted(self.times.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:24s} {v:8.3f}s ({v / max(total, 1e-9):5.1%})")
        return "\n".join(lines)


@contextlib.contextmanager
def phase_timer(profile: Optional[dict], name: str):
    """Accumulate elapsed seconds into ``profile[name]`` (no-op if None)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if profile is not None:
            profile[name] = profile.get(name, 0.0) + (
                time.perf_counter() - t0
            )


@contextlib.contextmanager
def device_trace(log_dir: str, *, device=None):
    """``torch.profiler`` trace of the block, written as a Chrome trace
    ``trace-<pid>-<ns>.json`` into ``log_dir``. ``device``: the device whose
    activity is traced with the host's (``None``: CUDA, which raises
    without a card; ``"cpu"`` traces the host alone). Yields the profiler
    (``key_averages()`` sums time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from .device import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
