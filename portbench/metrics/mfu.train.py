"""Percent of the cards' float32 peak that a train step's FLOPs (forward,
input and weight gradients of each of its chunks) would use at the
window's step time."""
from counts.unet_flops import train_step_flops

# NVIDIA H100 SXM, float32 outside the tensor cores (TF32 is off)
PEAK_FLOPS = 67e12


def read(run):
    if run["kind"] != "train":
        return None
    cfg = run["cfg"]
    flops = train_step_flops(run["chunk"],
                             encoder=tuple(cfg["encoder_channels"]),
                             out_channels=cfg["out_channels"])
    step_s = run["window_s"] / run["steps"]
    return 100.0 * flops * run["chunks_per_step"] / (step_s * PEAK_FLOPS
                                                    * run["chips"])
