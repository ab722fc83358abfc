"""Percent of the cards' float32 peak that the U-Net forward of the
window's frames would use: the forward FLOPs of every chunk of every frame
segmented (the padded slots of a microbatch are not counted), over the
window's seconds times the peak times the cards."""

from counts.unet_flops import forward_flops
from reference.unet import chunk_grid

# NVIDIA H100 SXM, float32 outside the tensor cores (TF32 is off)
PEAK_FLOPS = 67e12


def read(run):
    cfg = run["cfg"]
    if run["kind"] != "segment" or "encoder_channels" not in cfg:
        return None
    seg = cfg["segment"]
    chunks = len(chunk_grid(cfg["frame"], seg["chunk"], seg["margin"]))
    per_frame = chunks * forward_flops(
        seg["chunk"], encoder=tuple(cfg["encoder_channels"]),
        out_channels=cfg["out_channels"])
    frames = sum(c[2] for c in run["calls"] if c[3]) // (
        cfg["frame"][0] * cfg["frame"][1] * cfg["frame"][2])
    return 100.0 * frames * per_frame / (run["window_s"] * PEAK_FLOPS
                                         * run["chips"])
