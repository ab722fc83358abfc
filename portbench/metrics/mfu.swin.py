"""Percent of the cards' float32 peak that the Swin UNETR forward of the
window's frames would use: the forward FLOPs of every chunk of every frame
segmented (``counts.swin_unetr_flops``; the padded slots of a microbatch
are not counted), over the window's seconds times the peak times the
cards. ``mfu.segment``'s rule, for the Swin configuration."""

from counts.swin_unetr_flops import forward_flops
from reference.unet import chunk_grid

# NVIDIA H100 SXM, float32 outside the tensor cores (TF32 is off)
PEAK_FLOPS = 67e12
WIDTHS = ("feature_size", "in_channels", "out_channels", "depths",
          "num_heads", "window_size", "patch_size", "mlp_ratio")


def read(run):
    cfg = run["cfg"]
    if run["kind"] != "segment" or "feature_size" not in cfg:
        return None
    seg = cfg["segment"]
    chunks = len(chunk_grid(cfg["frame"], seg["chunk"], seg["margin"]))
    per_frame = chunks * forward_flops(seg["chunk"],
                                       **{k: cfg[k] for k in WIDTHS})
    frames = sum(c[2] for c in run["calls"] if c[3]) // (
        cfg["frame"][0] * cfg["frame"][1] * cfg["frame"][2])
    return 100.0 * frames * per_frame / (run["window_s"] * PEAK_FLOPS
                                         * run["chips"])
