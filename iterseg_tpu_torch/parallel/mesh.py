"""Device-mesh parallelism for inference and training.

The port of ``iterseg_tpu/parallel/mesh.py``. A ``Mesh`` is a named grid of
``torch.device``s, ``(data, space)`` as in JAX, and this module ports its
``data`` axis in full:

- ``sharded_predict_volume``: the chunks of one frame fill the ``data``
  devices, one chunk each per batch, the last batch zero-padded;
- ``make_sharded_train_step``: the global batch split over ``data``, one
  train-mode forward in lockstep over the shards, and BatchNorm statistics
  taken over the whole batch, as JAX's partitioner takes them. Each
  layer's per-shard sums are gathered on the first device, which computes
  the mean and then the centred variance (JAX's two-pass form) and sends
  both back. The loss is the loss function of the gathered outputs (the
  global mean), and each parameter's gradient is the sum of its shards'
  gradients in device order. The master parameters, the optimizer and the
  running statistics live on the first device.

Every transfer is a ``tensor.to(device)``, which autograd differentiates,
so the step runs on CUDA cards and, with a list such as ``[cpu, cpu]``, on
the CPU, where the tests hold it against the one-device step.

The ``space`` axis (each chunk's x axis sharded, with the halo exchanges
XLA's partitioner inserts in JAX) is not ported: a mesh whose ``space``
extent is above 1 raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..device import f32_numerics, resolve_device
from ..models.unet import UNet

__all__ = [
    "Mesh",
    "make_mesh",
    "replicate_params",
    "data_sharding",
    "sharded_apply",
    "make_sharded_train_step",
    "sharded_predict_volume",
]

SPACE_AXIS_ITEM = "ROADMAP Queue 1, item 'The space mesh axis'"


class Mesh:
    """A grid of ``torch.device``s with named axes (JAX's ``Mesh``):
    ``devices`` is a numpy object array, ``axis_names`` a tuple and
    ``shape`` a name -> size mapping."""

    def __init__(self, devices, axis_names=("data", "space")):
        nested = devices.tolist() if isinstance(devices, np.ndarray) else (
            devices)
        arr = np.array(nested, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}D device grid needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


def _factor2(n: int) -> Tuple[int, int]:
    """Split n devices into (data, space) — space gets at most 4."""
    for sp in (4, 2, 1):
        if n % sp == 0 and sp <= n:
            return n // sp, sp
    return n, 1


def make_mesh(n_devices: Optional[int] = None,
              axis_names=("data", "space"), devices=None) -> Mesh:
    """A 2D (data × space) mesh over ``devices`` (default: every CUDA card;
    raises without one, never falling back to the CPU), the first
    ``n_devices`` of them when given. The split is JAX's ``_factor2``:
    ``space`` takes 4 or 2 first, so 2 and 4 devices make a pure ``space``
    mesh, which the port does not run yet (``SPACE_AXIS_ITEM``)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    dp, sp = _factor2(len(devices))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, sp), axis_names)


def _data_devices(mesh: Mesh):
    """The devices along ``data`` of a mesh whose other axes have extent 1;
    a ``space`` extent above 1 raises ``NotImplementedError``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a parallel.mesh.Mesh, got {mesh!r}")
    if mesh.shape.get("space", 1) > 1:
        raise NotImplementedError(
            f"{mesh}: a 'space' extent above 1 shards each chunk's x axis, "
            "which needs halo-exchanged convolutions, aligned (0,1,1) pools "
            "and crops, and BatchNorm across the shards; the port runs the "
            f"'data' axis only until {SPACE_AXIS_ITEM}")
    if "data" not in mesh.axis_names:
        raise ValueError(f"{mesh} has no 'data' axis")
    return list(np.moveaxis(mesh.devices, mesh.axis_names.index("data"),
                            0).reshape(mesh.shape["data"], -1)[:, 0])


def replicate_params(params, mesh: Mesh):
    """One copy of the flat parameter dict (numpy arrays or tensors under
    the state-dict keys) on each ``data`` device, as a list in device
    order."""
    params = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v, np.float32)) for k, v in params.items()}
    return [{k: v.to(device=d, dtype=torch.float32)
             for k, v in params.items()} for d in _data_devices(mesh)]


def data_sharding(mesh: Mesh):
    """The batch split over ``data``: a function of an N-leading array or
    tensor that returns its N / data-extent row blocks, each on its
    device, in device order (N must divide, as in JAX). A list of one
    block a device is taken as already split."""
    devices = _data_devices(mesh)

    def shard(x):
        if isinstance(x, (list, tuple)):
            return [torch.as_tensor(part).to(d)
                    for part, d in zip(x, devices, strict=True)]
        x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
            x, torch.Tensor) else x)
        if x.shape[0] % len(devices):
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{len(devices)} data devices")
        return [part.to(d) for part, d in zip(
            x.chunk(len(devices)), devices)]

    return shard


def sharded_apply(params, spec, mesh: Mesh):
    """The eval forward with the batch sharded over ``data``: ``params`` is
    ``replicate_params``' list; ``run(x)`` returns the (N, C, z, y, x)
    float32 output gathered on the first device."""
    net = UNet(spec)
    devices = _data_devices(mesh)
    shard = data_sharding(mesh)

    def run(x):
        with torch.no_grad(), f32_numerics():
            outs = [torch.func.functional_call(net, p, (xk,))
                    for p, xk in zip(params, shard(x))]
        return torch.cat([o.to(devices[0]) for o in outs])

    return run


class _Lockstep:
    """The layer function of ``UNet.forward_shards`` for a train-mode
    forward over a batch split into shards, one per device. ``leaves`` holds
    one detached copy of every parameter per device, which each shard's
    layers read; their gradients are summed onto the master's by
    ``reduce_grads``. Each BatchNorm takes the statistics of the whole
    batch."""

    def __init__(self, net: UNet, devices):
        self.net = net
        self.devices = devices
        self.names = {m: name for name, m in net.named_modules()}
        self.leaves = {
            name: [p.detach().to(d).requires_grad_() for d in devices]
            for name, p in net.named_parameters()}
        self.stats = []  # (BatchNorm module, batch mean, batch var, count)

    def _gather(self, parts):
        """Sum per-shard tensors on the first device, in device order."""
        d0 = self.devices[0]
        return functools.reduce(torch.add, [p.to(d0) for p in parts])

    def __call__(self, m, xs):
        name = self.names[m]
        params = [{"weight": self.leaves[name + ".weight"][k],
                   "bias": self.leaves[name + ".bias"][k]}
                  for k in range(len(xs))]
        if isinstance(m, nn.BatchNorm3d):
            return self.batchnorm(m, xs, params)
        return [torch.func.functional_call(m, p, (x,))
                for p, x in zip(params, xs)]

    def batchnorm(self, bn, xs, params):
        n = sum(x.numel() // x.shape[1] for x in xs)
        # the sums accumulate in float64, as torch's CPU BatchNorm does
        f64, dtype = torch.float64, xs[0].dtype
        mean = (self._gather([x.sum((0, 2, 3, 4), dtype=f64) for x in xs])
                / n).to(dtype)
        means = [mean.to(x.device).reshape(1, -1, 1, 1, 1) for x in xs]
        var = (self._gather([((x - m) ** 2).sum((0, 2, 3, 4), dtype=f64)
                             for x, m in zip(xs, means)]) / n).to(dtype)
        self.stats.append((bn, mean.detach(), var.detach(), n))
        out = []
        for x, m, p in zip(xs, means, params):
            inv = torch.rsqrt(var.to(x.device) + bn.eps)
            out.append((x - m) * inv.reshape(1, -1, 1, 1, 1)
                       * p["weight"].reshape(1, -1, 1, 1, 1)
                       + p["bias"].reshape(1, -1, 1, 1, 1))
        return out

    def reduce_grads(self):
        """Each master parameter's gradient: the sum of its shards'
        gradients on the first device, in device order."""
        for name, p in self.net.named_parameters():
            grads = [leaf.grad for leaf in self.leaves[name]
                     if leaf.grad is not None]
            p.grad = self._gather(grads) if grads else None

    def update_running_stats(self):
        """JAX's ``batchnorm_train`` update of each BatchNorm's running
        statistics, from the whole batch's mean and unbiased variance."""
        with torch.no_grad():
            for bn, mean, var, n in self.stats:
                mom = bn.momentum
                bn.running_mean.copy_((1 - mom) * bn.running_mean
                                      + mom * mean)
                bn.running_var.copy_((1 - mom) * bn.running_var
                                     + mom * var * (n / max(n - 1, 1)))
                bn.num_batches_tracked.add_(1)


def make_sharded_train_step(mesh: Mesh, net: UNet, loss_fn, optimizer,
                            double_step=True, chan_log_fn=None,
                            n_channels=None):
    """The data-parallel train step: ``step(x, y, epoch=0)`` takes the
    global batch (x (N, 1, z, y, x), y (N, C, z, y, x), N a multiple of the
    ``data`` extent), splits x over ``data``, runs ``net.forward_shards``
    through ``_Lockstep``,
    takes ``loss_fn`` of the outputs gathered on the first device, sums the
    gradients onto ``net``'s parameters and steps ``optimizer`` (twice with
    ``double_step``, on the same gradients); then moves the running
    statistics. Returns the loss, and with ``chan_log_fn``/``n_channels``
    also the per-channel losses, as tensors on the first device.

    Where JAX passes the spec and threads (params, BatchNorm state,
    optimizer state) through a pure function, the port's state lives in
    ``net`` (the master module, on the first ``data`` device, in train
    mode) and in ``optimizer`` (over ``net``'s parameters)."""
    from ..train.losses import channel_losses

    devices = _data_devices(mesh)
    shard = data_sharding(mesh)

    def step(x, y, epoch=0):
        with f32_numerics():
            optimizer.zero_grad(set_to_none=True)
            lock = _Lockstep(net, devices)
            outs = net.forward_shards(shard(x), lock)
            out = torch.cat([o.to(devices[0]) for o in outs])
            y = torch.as_tensor(y).to(devices[0])
            loss = loss_fn(out, y, epoch)
            loss.backward()
            lock.reduce_grads()
            optimizer.step()
            if double_step:
                # the same un-zeroed gradients again (reference parity)
                optimizer.step()
            lock.update_running_stats()
            if chan_log_fn is None:
                return loss.detach()
            with torch.no_grad():
                chan = torch.stack(channel_losses(
                    out.detach(), y, chan_log_fn, n_channels, epoch))
            return loss.detach(), chan

    return step


def sharded_predict_volume(model, volume, mesh: Mesh,
                           chunk_size=(10, 256, 256), margin=(1, 64, 64)):
    """Chunk-grid inference with the chunk batch over ``data``: each batch
    gives one chunk to each ``data`` device (the model's per-device eval
    replica, ``UNetModel.module``), the last batch zero-padded; returns the
    (C, z, y, x) float32 numpy features. Batch b+1 is dispatched before
    batch b is assembled on the host."""
    from ..core.chunks import chunk_slices, make_chunks

    devices = _data_devices(mesh)
    dp = len(devices)
    volume = np.asarray(volume, dtype=np.float32)
    zyx = volume.shape[-3:]
    chunk_size = tuple(int(min(c, s)) for c, s in zip(chunk_size, zyx))
    starts, crops = make_chunks(zyx, chunk_size, margin)
    n = len(starts)
    out = np.zeros((model.out_channels,) + zyx, dtype=np.float32)

    def dispatch(b0):
        ys = []
        with torch.no_grad(), f32_numerics():
            for k, d in enumerate(devices):
                if b0 + k < n:
                    x = volume[chunk_slices(starts[b0 + k], chunk_size)]
                else:
                    x = np.zeros(chunk_size, np.float32)
                xk = torch.from_numpy(np.ascontiguousarray(x))[None, None]
                ys.append(model.module(d)(
                    xk.to(d).to(model.compute_dtype)).float())
        return ys

    def assemble(ys, b0):
        for k in range(min(dp, n - b0)):
            i = b0 + k
            cr = (slice(None),) + tuple(slice(int(lo), int(hi))
                                        for lo, hi in crops[i])
            yk = ys[k][0].cpu().numpy()
            sl = (slice(None),) + chunk_slices(starts[i], chunk_size)
            out[sl][cr] = yk[cr]

    pending = None
    for b0 in range(0, n, dp):
        ys = dispatch(b0)
        if pending is not None:
            assemble(*pending)
        pending = (ys, b0)
    if pending is not None:
        assemble(*pending)
    return out
