"""The ``segment_swin`` driver: the ``segment`` driver's whole calls of
``engine.segmentation.affinity_unet_watershed``, with a Swin UNETR as the
affinity network.

Configuration: the ``segment`` driver's keys (``frame``, ``frame_dtype``,
``assumed``, ``dtype``, ``tf32``, ``segment``), without ``checkpoint``:
the weights are drawn at set-up from ``weights_seed`` in MONAI's initial
distributions (``reference.swin_unetr.init_params``) and written as a
MONAI-named ``.pt`` under ``build/portbench/``, which the entry loads (a
checkout's later runs with the same seed and widths load that file:
``seeded_checkpoint``). As
the U-Net cells run one shipped checkpoint, every run of the cell runs
the same network, and the run's seed draws its frames: with weights drawn
per run, the sign of the mask channel's response to the blobs changes from
seed to seed, and with it the share of the frame that the host half floods
(an empty label volume on some seeds, thousands of objects on others). The
architecture keys (``in_channels``, ``out_channels``, ``feature_size``,
``depths``, ``num_heads``, ``window_size``, ``patch_size``, ``mlp_ratio``,
``learnt_parameters``) are checked against that state dict; ``norm`` and
``downsample`` name the only variant the program runs (instance norm,
v1 patch merging).

Its numbers: ``label_mismatch`` of the window's outputs against the
reference, as the ``segment`` driver compares them, and ``feature_gap``,
the largest absolute gap between the program's 5 features of each checked
frame (``predict_volume`` on the entry's checkpoint: the same chunked
forward program as the stack path, microbatch included) and the
reference's. The traced tail also records the window-attention kernel's
device seconds (every launch whose name holds ``KERNEL``).
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os

import numpy as np
import torch

from drivers import segment
from harness import trace
from reference import swin_unetr as ref_swin

# the program's window-attention kernel, as the device trace names it
KERNEL = "window_attention_fwd"
VARIANT = {"norm": "instance", "downsample": "merging"}


def check_widths(cfg, params):
    """Refuse a configuration whose architecture is not its weights'."""
    for key, value in ref_swin.widths(params).items():
        want = cfg[key]
        if (list(want) if isinstance(want, (list, tuple)) else want) != (
                list(value) if isinstance(value, (list, tuple)) else value):
            raise ValueError(f"{key} is {want!r} in the configuration but "
                             f"{value!r} in its weights")
    for key, value in VARIANT.items():
        if cfg[key] != value:
            raise ValueError(f"{key}: the program runs {value!r} only")


def seeded_checkpoint(directory, name, seed, widths):
    """``(path, state dict)``: the weights drawn from ``seed`` at
    ``widths``, in ``<directory>/<name>-<digest of both>.pt``. A checkout's
    later runs with the same seed and widths load that file instead of
    drawing and writing the 62 M parameters again; the file is written
    under a temporary name and renamed, so no run reads half of one."""
    note = json.dumps({"weights_seed": int(seed),
                       **{k: list(v) if isinstance(v, tuple) else v
                          for k, v in widths.items()}}, sort_keys=True)
    path = os.path.join(directory, f"{name}-"
                        f"{hashlib.sha256(note.encode()).hexdigest()[:12]}.pt")
    if os.path.exists(path):
        return path, torch.load(path, map_location="cpu", weights_only=True)
    params = ref_swin.init_params(seed, **widths)
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(params, tmp)
    os.replace(tmp, path)
    return path, params


def kernel_seconds(prof, name):
    """Device seconds of the launches whose name holds ``name``, inside the
    harness's spans (as ``trace.analyse`` clips them)."""
    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name in trace.SPANS and not trace._is_device(e)]
    if not spans:
        return 0.0
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    total = 0.0
    for e in events:
        if trace._is_device(e) and name in e.name:
            s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
            total += max(t - s, 0) / 1e6
    return total


class Driver(segment.Driver):
    def _entry(self, n_devices):
        from iterseg_tpu_torch.engine import segmentation as seg

        ctx, cfg = self.ctx, self.ctx.cfg
        s = cfg["segment"]
        if s["segmenter"] != segment.AFFINITY:
            raise ValueError(f"segmenter {s['segmenter']!r}: this driver "
                             "runs the affinity watershed")
        self.segmenter = segment.AFFINITY
        widths = {k: cfg[k] for k in ("in_channels", "out_channels",
                                       "feature_size")}
        widths.update(depths=tuple(cfg["depths"]),
                      heads=tuple(cfg["num_heads"]))
        self.ckpt, self.params = seeded_checkpoint(
            os.path.join(ctx.checkout, "build", "portbench"), cfg["name"],
            cfg["weights_seed"], widths)
        check_widths(cfg, self.params)
        segment.check_precision(cfg)
        self.chunk, self.margin = list(s["chunk"]), list(s["margin"])
        self.dtype = cfg["dtype"]
        flood = s["flood"]
        kw = {"devices": self._devices(n_devices),
              "device_flood": segment.FLOODS.get(flood, flood),
              "chunk_size": tuple(self.chunk), "margin": tuple(self.margin),
              "compute_dtype": self.dtype}
        return lambda x: seg.affinity_unet_watershed(
            None, x, None, "portbench", self.ckpt, **kw)

    def tail(self):
        with contextlib.redirect_stdout(io.StringIO()), \
                trace.profiled() as prof:
            for k in range(self.tail_calls):
                with torch.profiler.record_function("portbench.call"):
                    self.entry(self.inputs[k % len(self.inputs)])
        rec = trace.analyse(prof, self.ctx.chips)
        if rec is not None:
            rec["window_attention_s"] = kernel_seconds(prof, KERNEL)
        return rec

    def _params_on(self, dev):
        if getattr(self, "_dev_params", None) is None:
            self._dev_params = {k: v.to(dev) for k, v in self.params.items()}
        return self._dev_params

    def reference(self, frame, lower=False):
        """The reference's labels, in float32 with TF32 off; ``lower``: its
        convolutions and matmuls in TF32."""
        dev = self.ctx.device
        return ref_swin.affinity_labels(frame, self._params_on(dev),
                                        self.chunk, self.margin, dev,
                                        tf32=lower)

    def _reference_features(self, frame, lower=False):
        dev = self.ctx.device
        vol = segment.ref_segment._normalised(frame, dev)
        with segment.ref_segment.tf32_mode(lower):
            return ref_swin.features(self._params_on(dev), vol, self.chunk,
                                     self.margin).cpu().numpy()

    def _program_features(self, frame):
        from iterseg_tpu_torch.engine.predict import load_unet, predict_volume

        vol = np.asarray(frame, np.float32)
        model = load_unet(self.ckpt, compute_dtype=self.dtype)
        return predict_volume(model, vol / vol.max(), tuple(self.chunk),
                              tuple(self.margin), device=self.ctx.device)

    def check(self):
        """``label_mismatch`` as the ``segment`` driver takes it, and the
        worst ``feature_gap`` of the checked frames."""
        out = super().check()
        gap = 0.0
        for i in self._frames():
            frame = self.pool[i]
            gap = max(gap, float(np.abs(self._program_features(frame)
                                        - self._reference_features(frame))
                                 .max()))
        out["feature_gap"] = gap
        return out

    def control(self):
        """Both numbers for the reference in TF32, on the checked frames."""
        out = super().control()
        gap = 0.0
        for i in self._frames():
            frame = self.pool[i]
            gap = max(gap, float(np.abs(
                self._reference_features(frame, lower=True)
                - self._reference_features(frame)).max()))
        out["feature_gap"] = gap
        return out
