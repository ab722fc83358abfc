"""Percent of its roofline that the window-attention kernel reached in the
traced tail: the least time of the tail's attention work (per launch the
larger of its operations over 67 TFLOP/s, float32 outside the tensor
cores, and its bytes over 3.35 TB/s; ``counts.window_attention``, from the
configuration's geometry) over the kernel's device seconds in the tail
(the driver's ``window_attention_s``).

The work is the geometry's: every chunk of every frame the tail traced.
None when the program's counter ``window_attention_windows`` (windows x
heads it ran) is not the geometry's count for those chunks, so that
windows left out cannot read as speed, and None without the kernel's
seconds or the program's spans."""

from counts import window_attention as wa
from harness.spans import recorded
from reference.unet import chunk_grid

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def read(run):
    cfg = run["cfg"]
    tr = run.get("trace") or {}
    secs = tr.get("window_attention_s")
    if run["kind"] != "segment" or "feature_size" not in cfg or not secs:
        return None
    items = recorded(run)
    if not items:
        return None
    frames = sum(1 for s in items if s["kind"] == "span"
                 and s["name"] == "frame")
    counted = sum(s["value"] for s in items if s["kind"] == "counter"
                  and s["name"] == "window_attention_windows")
    seg = cfg["segment"]
    geometry = {"feature_size": cfg["feature_size"],
                "num_heads": cfg["num_heads"], "depths": cfg["depths"],
                "window_size": cfg["window_size"],
                "patch_size": cfg["patch_size"]}
    chunks = frames * len(chunk_grid(cfg["frame"], seg["chunk"],
                                     seg["margin"]))
    if not chunks or counted != chunks * wa.windows_heads(seg["chunk"],
                                                          **geometry):
        return None
    least = chunks * wa.roofline_seconds(seg["chunk"], PEAK_FLOPS,
                                         PEAK_BYTES, **geometry)
    return 100.0 * least / secs
