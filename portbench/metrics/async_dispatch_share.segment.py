"""Share, in %, of the traced tail's frames (the ``frame`` spans) whose
dispatch returned before their device work had run: the program's counter
``async_dispatch``, counted for a frame whose CUDA stream still has work
queued when its dispatch returns. A dispatch that waited for its own
frame's work (a synchronising copy) reads as not counted; one that waited
only behind the previous frame's launches still counts. None without
spans, and for a program that keeps no such counter."""
from harness.spans import recorded


def _key(s):
    return s["call"], s["frame"], s["card"]


def read(run):
    items = recorded(run)
    if not items:
        return None
    counted = {_key(s) for s in items
               if s["kind"] == "counter" and s["name"] == "async_dispatch"}
    frames = {_key(s) for s in items
              if s["kind"] == "span" and s["name"] == "frame"}
    if not counted or not frames:
        return None
    return 100.0 * len(frames & counted) / len(frames)
