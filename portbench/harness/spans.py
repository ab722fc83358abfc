"""The program's own spans and counters of a traced tail, as
``iterseg_tpu_torch.utils.spans()`` keeps them, for the per-layer readers.

The recorder fills only while a profiler records, so after a run it holds
the traced tail's calls alone. A run without them (untraced, or a program
that keeps no spans) reads as None.
"""

# the counters of what a call builds again (checkpoint reads, U-Net
# replicas, pipelines, chunked-forward programs)
BUILDS = ("checkpoint_reads", "unet_replicas", "pipelines",
          "feature_programs")


def recorded(run):
    """The tail's spans and counters that belong to one of its public
    calls, or None."""
    if run.get("kind") != "segment":
        return None
    try:
        from iterseg_tpu_torch import utils
    except ImportError:
        return None
    get = getattr(utils, "spans", None)
    if get is None:
        return None
    items = get()
    calls = {s["id"] for s in items
             if s["kind"] == "span" and s["name"] == "call"}
    if not calls:
        return None
    return [s for s in items if s["call"] in calls]


def _spans(items, name):
    return [s for s in items if s["kind"] == "span" and s["name"] == name]


def seconds(items, name):
    """Seconds in the spans ``name``, on every thread."""
    return sum(s["end_ns"] - s["start_ns"] for s in _spans(items, name)) / 1e9


def per_frame(run, *names, less=()):
    """Mean seconds a frame of the spans ``names`` less those of ``less``
    (frames: the ``frame`` spans), or None without spans or frames."""
    items = recorded(run)
    frames = len(_spans(items, "frame")) if items else 0
    if not frames:
        return None
    return (sum(seconds(items, n) for n in names)
            - sum(seconds(items, n) for n in less)) / frames


def per_call(run, name):
    """Mean seconds a call of the spans ``name``, or None."""
    items = recorded(run)
    if not items:
        return None
    return seconds(items, name) / len(_spans(items, "call"))


def builds_per_call(run):
    """Mean count of what a call built (``BUILDS``), or None."""
    items = recorded(run)
    if not items:
        return None
    built = sum(s["value"] for s in items
                if s["kind"] == "counter" and s["name"] in BUILDS)
    return built / len(_spans(items, "call"))
