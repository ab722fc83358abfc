"""The device's busy time and its gaps, from a ``torch.profiler`` trace.

The harness opens its own spans (``torch.profiler.record_function``)
around what it drives: ``portbench.call`` around each segmenter call and
``portbench.steps`` over a run of train steps. The traced window runs from
the first such span's start to the last one's end. Busy time is the union
of the device's activity intervals (kernels, copies, sets) inside it,
averaged over the cards; user annotations on the device timeline span the
gaps between their kernels and are left out. Each idle gap is named by the
harness span open over it and the last top-level host-side torch
operation that started before it.
"""
from __future__ import annotations

import bisect
import contextlib

import torch

SPANS = ("portbench.call", "portbench.steps")
TOP = 10


@contextlib.contextmanager
def profiled():
    """A ``torch.profiler.profile`` of host and device activity; the
    device is synchronised before it stops."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        torch.cuda.synchronize()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_device(e):
    return (str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and e.time_range.end > e.time_range.start)


def _top_level(e):
    p = e.cpu_parent
    return p is None or p.name in SPANS


def analyse(prof, devices=1):
    """``{"busy_s", "window_s", "device_ops", "idle_gaps"}`` of the traced
    window, or None when the trace holds no harness span or no device
    activity in it."""
    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.name in SPANS and not _is_device(e))
    if not spans:
        return None
    lo, hi = spans[0][0], max(e for _, e, _ in spans)
    per_dev, per_name = {}, {}
    for e in events:
        if not _is_device(e):
            continue
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t <= s:
            continue
        per_dev.setdefault(e.device_index, []).append((s, t))
        name = e.name[:120]
        per_name[name] = per_name.get(name, 0.0) + (t - s) / 1e6
    if not per_dev:
        return None
    merged = {d: _merge(iv) for d, iv in per_dev.items()}
    busy = sum(sum(e - s for s, e in m) for m in merged.values())
    busy_s = busy / 1e6 / max(devices, 1)
    main = {e.thread for e in events if e.name in SPANS}
    ops = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if not _is_device(e) and e.name not in SPANS
                  and e.thread in main and _top_level(e)
                  and str(e.device_type).endswith("CPU")))
    starts = [o[0] for o in ops]

    def host_op(s, t):
        """The last top-level host operation that started before the gap:
        what the host was doing when the device ran dry."""
        i = bisect.bisect_right(starts, s)
        return "after " + ops[i - 1][2] if i else "no torch op before"

    # each gap split at the harness spans' edges, each piece named by the
    # span over it ("between calls" outside every span)
    edges = sorted({x for a, b, _ in spans for x in (a, b)})
    gaps = {}
    for m in merged.values():
        bounds = [lo] + [x for iv in m for x in iv] + [hi]
        for s, t in zip(bounds[0::2], bounds[1::2]):
            cuts = [s] + [x for x in edges if s < x < t] + [t]
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                label = next((n.split(".")[-1] for x, y, n in spans
                              if x <= mid <= y), "between calls")
                key = f"{label}: {host_op(a, b)}"[:120]
                gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e6
    def rank(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:TOP]

    return {"busy_s": busy_s, "window_s": (hi - lo) / 1e6,
            "device_ops": [[k, v] for k, v in rank(per_name)],
            "idle_gaps": [[k, v] for k, v in rank(gaps)]}
