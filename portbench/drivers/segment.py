"""The ``segment`` driver: whole calls of a segmenter, back to back, one
caller, through the program's public entries
``engine.segmentation.affinity_unet_watershed`` and ``dog_blob_watershed``.

Configuration: ``frame``, ``frame_dtype`` and ``assumed`` make the seeded
frames; ``dtype`` is the entry's ``compute_dtype``; ``segment`` names the
segmenter and its settings, where ``flood`` is the entry's ``device_flood``
("host": the exact host flood, False; else the mode's name, or true).
The affinity segmenter also reads ``checkpoint``, its widths (checked
against the checkpoint's arrays) and ``tf32``. The ``train`` section is
the train driver's.

Mix: ``devices`` (cards a stack's frames round-robin over),
``frames_per_call`` (a (t, z, y, x) stack of that many frames drawn from
the pool a call; 0: single (z, y, x) frames), ``distinct_calls``,
``pool``, ``checked_frames`` (outputs compared with the reference: for a
stack, at least one at every stack position, each of a call drawn from
the seed) and ``tail`` (calls traced).
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from harness import compare, frames, trace
from harness.bench import free
from reference import segment as ref_segment
from reference import unet as ref_unet

FLOODS = {"host": False}
AFFINITY, DOG = "affinity-unet-watershed", "DoG-blob-watershed"
# what the DoG entry runs and takes no argument for
DOG_FIXED = {"sigma_ratio": 1.6, "overlap": 0.5}


def check_widths(cfg, params):
    """Refuse a configuration whose widths are not its checkpoint's."""
    for key, value in ref_unet.widths(params).items():
        if cfg[key] != value:
            raise ValueError(f"{key} is {cfg[key]!r} in the configuration "
                             f"but {value!r} in its checkpoint")


def check_precision(cfg):
    """The program's convolutions run float32 with TF32 off
    (``device.f32_numerics``): it has no TF32 path to run."""
    if cfg["tf32"]:
        raise ValueError("tf32: the program keeps TF32 off; no path to run")


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.cfg, ctx.mix
        cfg.skip("train")
        a = cfg["assumed"]
        self.pool = frames.frame_pool(ctx.seed, mix["pool"], cfg["frame"],
                                      a["blobs_per_frame"], a["peak"],
                                      a["noise"], ctx.device,
                                      cfg["frame_dtype"])
        rng = np.random.default_rng(int(ctx.seed) % (1 << 63))
        per_call = int(mix["frames_per_call"])
        if per_call:
            self.calls = [rng.choice(len(self.pool), per_call,
                                     replace=False).tolist()
                          for _ in range(mix["distinct_calls"])]
            self.inputs = [np.stack([self.pool[i] for i in c])
                           for c in self.calls]
        else:
            self.calls = [[int(i)] for i in rng.permutation(len(self.pool))]
            self.inputs = [self.pool[c[0]] for c in self.calls]
        self.stacked = bool(per_call)
        self.checked = self._checked(rng, int(mix["checked_frames"]),
                                     max(per_call, 1))
        self.tail_calls = int(mix["tail"])
        self.entry = self._entry(int(mix["devices"]))

    def _checked(self, rng, n, width):
        """``{(call, position): []}``: slot j checks position j % width of
        a call drawn from the seed (a call not yet drawn for it)."""
        if n < width:
            raise ValueError(f"checked_frames {n}: a stack of {width} "
                             "frames needs one at every position")
        slots = {}
        for j in range(n):
            p = j % width
            free_calls = [c for c in range(len(self.calls))
                          if (c, p) not in slots]
            slots[(int(rng.choice(free_calls)), p)] = []
        return slots

    def _devices(self, n):
        """The entry's ``devices``: None (the default card) for one CUDA
        card; on the CPU the given devices in turn."""
        cards = self.ctx.cards
        if cards[0].type != "cuda":
            return [cards[i % len(cards)] for i in range(n)]
        if n > len(cards):
            raise ValueError(f"devices {n}: the cell has {len(cards)} cards")
        return None if n == 1 else cards[:n]

    def _entry(self, n_devices):
        from iterseg_tpu_torch.engine import segmentation as seg

        ctx, cfg = self.ctx, self.ctx.cfg
        s = cfg["segment"]
        flood = s["flood"]
        kw = {"devices": self._devices(n_devices),
              "device_flood": FLOODS.get(flood, flood)}
        self.segmenter = s["segmenter"]
        if self.segmenter == AFFINITY:
            self.ckpt = os.path.join(ctx.checkout, cfg["checkpoint"])
            check_widths(cfg, ref_unet.load_params(self.ckpt, "cpu"))
            check_precision(cfg)
            self.chunk, self.margin = list(s["chunk"]), list(s["margin"])
            kw.update(chunk_size=tuple(self.chunk), margin=tuple(self.margin),
                      compute_dtype=cfg["dtype"])
            return lambda x: seg.affinity_unet_watershed(
                None, x, None, "portbench", self.ckpt, **kw)
        if self.segmenter == DOG:
            if cfg["dtype"] != "float32":
                raise ValueError("dtype: the DoG entry runs float32 only")
            self.dog = {k: float(s[k]) for k in ("min_sigma", "max_sigma",
                                                 "sigma_ratio", "threshold",
                                                 "overlap")}
            for k, v in DOG_FIXED.items():
                if self.dog[k] != v:
                    raise ValueError(f"{k}: the DoG entry runs {v} only")
            path = os.path.join(ctx.checkout, "build", "portbench",
                                cfg["name"] + ".json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump({k: self.dog[k] for k in
                           ("min_sigma", "max_sigma", "threshold")}, f)
            return lambda x: seg.dog_blob_watershed(
                None, x, None, "portbench", path, **kw)
        raise ValueError(f"unknown segmenter {self.segmenter!r}")

    def warm(self):
        """One call of each shape the window sends (all calls share one)."""
        with contextlib.redirect_stdout(io.StringIO()):
            self.entry(self.inputs[0])

    def _keep(self, c, out):
        for (c2, p), kept in self.checked.items():
            if c2 != c:
                continue
            o = out[p] if self.stacked else out
            if not any(np.array_equal(o, k) for k in kept):
                kept.append(np.array(o, copy=True))

    def window(self, seconds):
        """Whole calls back to back until ``seconds`` have passed and each
        distinct call has run once."""
        calls, k, reported = [], 0, False
        sink = io.StringIO()
        while True:
            x = self.inputs[k % len(self.inputs)]
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(sink):
                    out = self.entry(x)
                ok = True
            except Exception:  # counted as failed; the window runs on
                out, ok = None, False
                if not reported:
                    traceback.print_exc(file=sys.stderr)
                    reported = True
            t1 = time.perf_counter()
            calls.append((t0, t1, int(x.size), ok))
            if ok:
                self._keep(k % len(self.calls), out)
            sink.seek(0)
            sink.truncate()
            k += 1
            if t1 - calls[0][0] >= seconds and k >= len(self.inputs):
                break
        return {"kind": "segment", "t_start": calls[0][0],
                "window_s": calls[-1][1] - calls[0][0], "calls": calls}

    def tail(self):
        with contextlib.redirect_stdout(io.StringIO()), \
                trace.profiled() as prof:
            for k in range(self.tail_calls):
                with torch.profiler.record_function("portbench.call"):
                    self.entry(self.inputs[k % len(self.inputs)])
        return trace.analyse(prof, self.ctx.chips)

    def release(self):
        self.entry = None
        free(self.ctx.device)

    def reference(self, frame, lower=False):
        """The reference's labels, in float32 with TF32 off; ``lower``: in
        the precision below (TF32 convolutions; bfloat16 filters)."""
        dev = self.ctx.device
        if self.segmenter == AFFINITY:
            if not hasattr(self, "_params"):
                self._params = ref_unet.load_params(self.ckpt, dev)
            return ref_segment.affinity_labels(
                frame, self._params, self.chunk, self.margin, dev,
                tf32=lower)
        return ref_segment.dog_labels(
            frame, self.dog, dev, torch.bfloat16 if lower else torch.float32)

    def _frames(self):
        """The pool indices of the checked frames."""
        return sorted({self.calls[c][p] for c, p in self.checked})

    def check(self):
        """The worst ``label_mismatch`` of the window's outputs of the
        checked slots (1 for a slot that no call returned)."""
        refs = {i: self.reference(self.pool[i]) for i in self._frames()}
        worst = 0.0
        for (c, p), outs in self.checked.items():
            ref = refs[self.calls[c][p]]
            for o in outs or [None]:
                worst = max(worst, 1.0 if o is None else
                            compare.label_mismatch(o, ref))
        return {"label_mismatch": worst}

    def control(self):
        """The same number for the reference in the precision below the
        configuration's, on the checked frames."""
        worst = 0.0
        for i in self._frames():
            worst = max(worst, compare.label_mismatch(
                self.reference(self.pool[i], lower=True),
                self.reference(self.pool[i])))
        return {"label_mismatch": worst}
