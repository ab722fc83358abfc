"""The ``train`` driver: one ``train.train.train_unet`` call over chunks
drawn in turn from a seeded pool.

Configuration: ``checkpoint`` and its widths (checked against its
arrays), ``dtype`` and ``tf32`` (the program trains float32 with TF32 off
and has no other path), ``frame``, ``frame_dtype`` and ``assumed`` (the
frames the chunks are cropped from) and the ``train`` section: ``lr``,
``loss``, ``double_step``, and the ``targets`` made of each chunk's
ground truth with the voxel ``scale``. The ``segment`` section is the
segment driver's.

Mix: ``pool`` distinct chunks of ``chunk`` from ``source_frames`` frames;
``compared_steps`` (held against the reference), ``warm_steps`` (the
warm-up call, which calibrates the window), ``min_steps``, ``tail`` (steps
traced) and optionally ``mesh`` ([data, space]: ``train_unet(mesh=)`` over
that many of the cell's cards, data chunks a step).

The first ``compared_steps`` steps are held against the reference; the
window starts right after the next step's dispatch and ends at the call's
return, after the last step's loss read.
"""
from __future__ import annotations

import contextlib
import io
import math
import os
import sys
import time

import numpy as np
import torch

from drivers.segment import check_precision, check_widths
from harness import compare, frames, trace
from harness.bench import free
from reference import train as ref_train
from reference import unet as ref_unet


class _Chunk:
    """A training chunk that notes when the trainer first reads it."""

    def __init__(self, array, step, on_read):
        self.array, self.step, self.on_read = array, step, on_read

    def __array__(self, dtype=None, copy=None):
        self.on_read(self.step)
        return self.array if dtype is None else self.array.astype(dtype)


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.cfg, ctx.mix
        cfg.skip("segment")
        self.ckpt = os.path.join(ctx.checkout, cfg["checkpoint"])
        check_widths(cfg, ref_unet.load_params(self.ckpt, "cpu"))
        check_precision(cfg)
        if cfg["dtype"] != "float32":
            raise ValueError("dtype: train_unet trains float32 only")
        self.t = cfg["train"]
        self.lr, self.loss = float(self.t["lr"]), self.t["loss"]
        self.double_step = bool(self.t["double_step"])
        ref_train.check_loss(self.loss)
        a = cfg["assumed"]
        pool = frames.train_chunks(
            ctx.seed, mix["pool"], mix["chunk"], mix["source_frames"],
            cfg["frame"], a["blobs_per_frame"], a["peak"], a["noise"],
            ctx.device, cfg["frame_dtype"], self.t["targets"],
            self.t["scale"])
        self.xs = [p[0] for p in pool]
        self.ys = [p[1] for p in pool]
        self.chunk = list(mix["chunk"])
        self.first = int(mix["compared_steps"])
        self.warm_steps = int(mix["warm_steps"])
        self.min_steps = int(mix["min_steps"])
        self.tail_steps = int(mix["tail"])
        self.mesh_shape = mix.get("mesh")
        self.per_step = int(self.mesh_shape[0]) if self.mesh_shape else 1
        self.step_s = None

    def _mesh(self):
        """``train_unet``'s ``mesh`` (None: the batch-1 loop on the cell's
        card)."""
        if not self.mesh_shape:
            return None
        from iterseg_tpu_torch.parallel.mesh import Mesh

        dp, sp = (int(n) for n in self.mesh_shape)
        cards = self.ctx.cards
        if cards[0].type == "cuda" and dp * sp > len(cards):
            raise ValueError(f"mesh {dp}x{sp}: the cell has {len(cards)} "
                             "cards")
        arr = np.empty(dp * sp, dtype=object)
        arr[:] = [cards[i % len(cards)] for i in range(dp * sp)]
        return Mesh(arr.reshape(dp, sp), ("data", "space"))

    def _call(self, steps, on_read, profile=None, update_every=20):
        from iterseg_tpu_torch.train.train import train_unet

        n = steps * self.per_step
        x = [_Chunk(self.xs[k % len(self.xs)], k // self.per_step, on_read)
             for k in range(n)]
        y = [self.ys[k % len(self.ys)] for k in range(n)]
        dev = self.ctx.device
        train_unet(x, [], y, [], weights=self.ckpt, epochs=1, lr=self.lr,
                   loss_function=self.loss, double_step=self.double_step,
                   validate=False, log=False, out_dir=None,
                   update_every=update_every, profile=profile,
                   device=None if dev.type == "cuda" else dev,
                   mesh=self._mesh())

    @staticmethod
    def _reads():
        times = {}

        def on_read(k):
            times.setdefault(k, time.perf_counter())
        return times, on_read

    def warm(self):
        """A call of ``warm_steps`` steps: builds and warms every shape,
        and times the steps that calibrate the window's length."""
        n = self.warm_steps
        times, on_read = self._reads()
        with contextlib.redirect_stdout(io.StringIO()):
            self._call(n, on_read)
        end = time.perf_counter()
        self.step_s = (end - times[self.first]) / (n - self.first + 1)

    def _hooks(self, state):
        """Optimizer hooks, idle after the compared steps: the leaves'
        names, matched to the checkpoint by value before the first update;
        the first gradients; the leaves after the compared steps. What
        they keep is copied to the host (before the window), so the
        device's peak is the program's."""
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)

        init = ref_unet.load_params(self.ckpt, "cpu")
        names = ref_unet.trainable(init)
        done = self.first * (2 if self.double_step else 1)
        state["updates"] = 0

        def leaves(opt):
            return [p for g in opt.param_groups for p in g["params"]]

        def pre(opt, args, kwargs):
            if "names" in state:
                return
            found = []
            for p in leaves(opt):
                host = p.detach().cpu()
                match = [k for k in names if k not in found
                         and init[k].shape == host.shape
                         and torch.equal(init[k], host)]
                if len(match) != 1:
                    raise RuntimeError("cannot name an optimised leaf")
                found.append(match[0])
            state["names"] = found

        def post(opt, args, kwargs):
            if state["updates"] >= done:
                return
            state["updates"] += 1
            named = dict(zip(state["names"], leaves(opt)))
            if state["updates"] == 1:
                state["grad"] = {k: p.grad.detach().cpu().clone()
                                 for k, p in named.items()}
            if state["updates"] == done:
                state["after"] = {k: p.detach().cpu().clone()
                                  for k, p in named.items()}

        state["handles"] = [register_optimizer_step_pre_hook(pre),
                            register_optimizer_step_post_hook(post)]
        state["init"] = init

    def window(self, seconds):
        n = max(self.min_steps, math.ceil(seconds / self.step_s))
        steps = self.first + n
        times, on_read = self._reads()
        self.state, profile, sink = {}, {}, io.StringIO()
        self._hooks(self.state)
        try:
            with contextlib.redirect_stdout(sink):
                self._call(steps, on_read, profile=profile, update_every=1)
        finally:
            for h in self.state["handles"]:
                h.remove()
        end = time.perf_counter()
        start = times[self.first + 1]
        self.losses = [float(line.rsplit(":", 1)[1]) for line in
                       sink.getvalue().splitlines()
                       if "running loss:" in line][:self.first]
        return {"kind": "train", "t_start": start, "window_s": end - start,
                "steps": steps - self.first,
                "load_s": profile["load_s"][self.first + 1:],
                "chunk": self.chunk, "chunks_per_step": self.per_step}

    def tail(self):
        """A second call of ``tail`` steps, traced; the harness's span
        runs over the steps after the first ``compared_steps`` + 1."""
        span = {}
        lo, hi = self.first + 1, self.tail_steps - 1

        def on_read(k):
            if k == lo and "rf" not in span and "done" not in span:
                span["rf"] = torch.profiler.record_function(
                    "portbench.steps")
                span["rf"].__enter__()
            elif k == hi and "rf" in span:
                span.pop("rf").__exit__(None, None, None)
                span["done"] = True

        with contextlib.redirect_stdout(io.StringIO()), \
                trace.profiled() as prof:
            self._call(self.tail_steps, on_read)
        return trace.analyse(prof, self.ctx.chips)

    def release(self):
        free(self.ctx.device)

    def _batches(self, dtype=torch.float32):
        """The compared steps' chunks, stacked a step, on the card."""
        dev, n = self.ctx.device, self.per_step
        out = []
        for s in range(self.first):
            ks = [(s * n + j) % len(self.xs) for j in range(n)]
            out.append(tuple(torch.from_numpy(np.stack([arr[k] for k in ks]))
                             .to(dev, dtype) for arr in (self.xs, self.ys)))
        return out

    def _reference(self, tf32=False, half=False):
        params = ref_unet.load_params(self.ckpt, self.ctx.device)
        init = {k: v.clone() for k, v in params.items()}
        losses, grads = ref_train.run_steps(params, self._batches(), self.lr,
                                            self.double_step, tf32, half)
        change = {k: params[k] - init[k] for k in grads}
        return losses, _norms(grads), _norms(change)

    def kept(self):
        """The leaves compared: those whose first gradient, in float64, is
        at least a thousandth of the median leaf's (the conv biases right
        before a BatchNorm have an exact gradient of nought, and in float32
        only round-off). Also prints the ones left out."""
        if not hasattr(self, "_kept"):
            params = ref_unet.load_params(self.ckpt, self.ctx.device,
                                          torch.float64)
            _, grads = ref_train.run_steps(
                params, self._batches(torch.float64)[:1], self.lr,
                self.double_step)
            norms = _norms(grads)
            self._kept = compare.moved_leaves(norms)
            med = float(np.median(list(norms.values())))
            self.left_out = {k: norms[k] / med for k in norms
                             if k not in self._kept}
            del params, grads
            free(self.ctx.device)
        return self._kept

    def _gaps(self, side, ref, median=False):
        """The compared numbers: the worst kept leaf's gaps of the first
        gradient and of the change, and the median kept leaf's gap of the
        change (the worst change is the round-off of Adam's steps on
        elements whose gradient is near nought, so it has its own, wider
        limit); with ``median`` also the median leaf's gradient gap (a
        reading kept beside them)."""
        losses, grads, change = side
        r_losses, r_grads, r_change = ref
        kept = self.kept()
        g = compare.leaf_gaps(grads, r_grads, kept)
        c = compare.leaf_gaps(change, r_change, kept)
        out = {"loss_gap": compare.loss_gap(losses, r_losses),
               "grad_gap": max(g.values()), "change_gap": max(c.values()),
               "change_gap_median": float(np.median(list(c.values())))}
        if median:
            out["grad_gap_median"] = float(np.median(list(g.values())))
        return out

    def program(self):
        """The program's losses and leaf norms of the compared steps."""
        s = self.state
        return (self.losses, _norms(s["grad"]),
                _norms({k: s["after"][k] - s["init"][k] for k in s["after"]}))

    def check(self, median=False):
        program = self.program()
        del self.state
        free(self.ctx.device)
        ref = self._reference()
        kept = self.kept()
        for k, share in sorted(self.left_out.items()):
            print("leaf %s left out: float64 gradient %.3e of the median"
                  % (k, share), file=sys.stderr)
        for what, i in (("grad", 1), ("change", 2)):
            for row in compare.worst_leaves(program[i], ref[i], kept):
                print("leaf %s %s program %.6e reference %.6e gap %.3e"
                      % ((what,) + row), file=sys.stderr)
        return self._gaps(program, ref, median)

    def control(self, median=False):
        return self._gaps(self._reference(tf32=True), self._reference(),
                          median)

    def fault_half_batch(self, median=False):
        return self._gaps(self._reference(half=True), self._reference(),
                          median)

    def fault_state_unchanged(self):
        """Steps that leave the leaves as they were (the first gradient
        and the losses as the reference's)."""
        losses, grads, change = self._reference()
        return self._gaps((losses, grads, dict.fromkeys(change, 0.0)),
                          (losses, grads, change))
