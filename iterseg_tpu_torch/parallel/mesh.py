"""Device-mesh parallelism for inference and training.

The port of ``iterseg_tpu/parallel/mesh.py``. A ``Mesh`` is a named grid of
``torch.device``s, ``(data, space)`` as in JAX: a batch's N axis goes over
``data`` and each chunk's x axis over ``space`` (``data_sharding``), so the
shards are data x space blocks, listed data-major.

- ``sharded_apply`` and ``sharded_predict_volume`` (the chunks of one frame
  over ``data``, the last batch zero-padded) run the eval forward;
- ``make_sharded_train_step`` runs one train-mode forward in lockstep over
  the blocks, with BatchNorm statistics taken over every owned voxel of the
  global batch, as JAX's partitioner takes them. Each layer's per-block
  sums are gathered on the first device, which computes the mean and then
  the centred variance (JAX's two-pass form) and sends both back. The loss
  is the loss function of the gathered output (the global mean), and each
  parameter's gradient is the sum of its blocks' gradients in block order.
  The master parameters, the optimizer and the running statistics live on
  the first device.

Both run the U-Net's one forward, ``UNet.forward_shards``. Along ``space``
it goes through ``models.unet.XSplit``: at every level each block owns a
balanced share of that level's x planes and fetches the halo planes each
conv, pool and upsample reads from the blocks that own them (the exchanges
XLA's partitioner inserts in JAX). Every transfer is a ``tensor.to(device)``,
which autograd differentiates, so the same code runs on CUDA cards, on one
card listed several times, and on CPU lists such as ``[cpu] * 4``, where
the tests hold it against the one-device forward and step and against JAX.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..device import f32_numerics, resolve_device
from ..models.swin_unetr import SwinUNETRSpec
from ..models.unet import UNet, XSplit

__all__ = [
    "Mesh",
    "make_mesh",
    "replicate_params",
    "data_sharding",
    "sharded_apply",
    "make_sharded_train_step",
    "sharded_predict_volume",
]


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
    ``space`` takes 4 or 2 first, so 2 and 4 devices make a (1, 2) and a
    (1, 4) mesh and 8 a (2, 4) one."""
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


def _grid(mesh: Mesh):
    """``(data extent, space extent, devices)``: the mesh's devices listed
    data-major, one a block."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a parallel.mesh.Mesh, got {mesh!r}")
    if ("data" not in mesh.axis_names
            or not set(mesh.axis_names) <= {"data", "space"}):
        raise ValueError(f"{mesh}: the axes must be 'data' and 'space'")
    grid = mesh.devices if mesh.axis_names[0] == "data" else mesh.devices.T
    return (mesh.shape["data"], mesh.shape.get("space", 1),
            list(grid.reshape(-1)))


def _blocks(x, dp, sp):
    """The data x space blocks of an (N, ..., x) tensor, data-major: N must
    divide by ``dp`` and x by ``sp``, as in JAX."""
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{dp} data devices")
    if x.shape[-1] % sp:
        raise ValueError(f"an x axis of {x.shape[-1]} does not split over "
                         f"{sp} space devices")
    return [blk for rows in x.chunk(dp) for blk in rows.chunk(sp, -1)]


def _gather(outs, sp, device):
    """The blocks' outputs as one tensor on ``device``: each row's blocks
    joined along x, the rows along N."""
    return torch.cat([torch.cat([o.to(device) for o in outs[r:r + sp]], -1)
                      for r in range(0, len(outs), sp)])


def replicate_params(params, mesh: Mesh):
    """One copy of the flat parameter dict (numpy arrays or tensors under
    the state-dict keys) on each device of the mesh, as a list in block
    order (a device listed twice gets two entries)."""
    params = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v, np.float32)) for k, v in params.items()}
    return [{k: v.to(device=d, dtype=torch.float32)
             for k, v in params.items()} for d in _grid(mesh)[2]]


def data_sharding(mesh: Mesh):
    """The batch split over the mesh: a function of an (N, C, z, y, x)
    array or tensor that returns its data x space blocks (N over ``data``,
    x over ``space``; each must divide, else ``ValueError``), each on its
    device, data-major. A list of one block a device is taken as already
    split."""
    dp, sp, devices = _grid(mesh)

    def shard(x):
        if isinstance(x, (list, tuple)):
            return [torch.as_tensor(part).to(d)
                    for part, d in zip(x, devices, strict=True)]
        x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
            x, torch.Tensor) else x)
        return [blk.to(d) for blk, d in zip(_blocks(x, dp, sp), devices)]

    return shard


class _Replicas:
    """The layer function of ``UNet.forward_shards`` for the eval forward:
    each block's leaf modules from the network copy of its own position
    (``nets``, one a block; the first is the one the forward walks)."""

    def __init__(self, nets):
        self.names = {m: name for name, m in nets[0].named_modules()}
        self.modules = [dict(net.named_modules()) for net in nets]

    def __call__(self, m, xs, **kw):
        name = self.names[m]
        return [mods[name](x, **kw) for mods, x in zip(self.modules, xs)]


def _eval_forward(nets, shards, sp):
    """The eval forward of the blocks ``shards`` through ``nets``."""
    with torch.no_grad(), f32_numerics():
        return nets[0].forward_shards(shards, _Replicas(nets), XSplit(sp))


def _net_holding(spec, state):
    """An eval ``UNet`` on the device of ``state`` (a flat tensor dict
    under the state-dict keys) holding those tensors."""
    device = next(iter(state.values())).device
    net = UNet(spec).to(device)
    missing, unexpected = net.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise KeyError(f"parameters missing {missing}, unexpected "
                       f"{unexpected}")
    return net.eval()


def _unet_only(spec):
    """Raise ``ValueError`` for a Swin UNETR: the mesh paths run the
    U-Net's ``forward_shards``, which it has not."""
    if isinstance(spec, SwinUNETRSpec):
        raise ValueError("the mesh paths run the U-Net only; a Swin UNETR "
                         "runs whole frames on each card (devices=[...])")


def sharded_apply(params, spec, mesh: Mesh):
    """The eval forward over the mesh's blocks: ``params`` is
    ``replicate_params``' list; ``run(x)`` takes an (N, C, z, y, x) batch
    (``data_sharding``'s rules) and returns the (N, C', z, y, x) float32
    output gathered on the first device."""
    _unet_only(spec)
    dp, sp, devices = _grid(mesh)
    if len(params) != len(devices):
        raise ValueError(f"{len(params)} parameter copies for the "
                         f"{len(devices)} devices of {mesh}")
    nets = [_net_holding(spec, p) for p in params]
    shard = data_sharding(mesh)

    def run(x):
        return _gather(_eval_forward(nets, shard(x), sp), sp, devices[0])

    return run


class _Lockstep:
    """The layer function of ``UNet.forward_shards`` for a train-mode
    forward over a batch split into blocks, one per mesh position.
    ``leaves`` holds one detached copy of every parameter per block, which
    each block's layers read; their gradients are summed onto the master's
    by ``reduce_grads``. Each BatchNorm takes the statistics of the whole
    batch: the blocks hold only their owned planes, so every voxel counts
    once."""

    def __init__(self, net: UNet, devices):
        self.net = net
        self.devices = devices
        self.names = {m: name for name, m in net.named_modules()}
        self.leaves = {
            name: [p.detach().to(d).requires_grad_() for d in devices]
            for name, p in net.named_parameters()}
        self.stats = []  # (BatchNorm module, batch mean, batch var, count)

    def _gather(self, parts):
        """Sum per-block tensors on the first device, in block order."""
        d0 = self.devices[0]
        return functools.reduce(torch.add, [p.to(d0) for p in parts])

    def __call__(self, m, xs, **kw):
        name = self.names[m]
        params = [{"weight": self.leaves[name + ".weight"][k],
                   "bias": self.leaves[name + ".bias"][k]}
                  for k in range(len(xs))]
        if isinstance(m, nn.BatchNorm3d):
            return self.batchnorm(m, xs, params)
        return [torch.func.functional_call(m, p, (x,), kw)
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
        """Each master parameter's gradient: the sum of its blocks'
        gradients on the first device, in block order (data-major, then
        space), whatever order autograd's device threads end in."""
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
    """The data x space parallel train step: ``step(x, y, epoch=0)`` takes
    the global batch (x (N, 1, z, y, x), y (N, C, z, y, x); ``data_sharding``'s
    rules), splits x into the mesh's blocks, runs ``net.forward_shards``
    through ``_Lockstep`` and ``XSplit``, takes ``loss_fn`` of the output
    gathered on the first device, sums the gradients onto ``net``'s
    parameters and steps ``optimizer`` (twice with ``double_step``, on the
    same gradients); then moves the running statistics. Returns the loss,
    and with ``chan_log_fn``/``n_channels`` also the per-channel losses, as
    tensors on the first device.

    Where JAX passes the spec and threads (params, BatchNorm state,
    optimizer state) through a pure function, the port's state lives in
    ``net`` (the master module, on the mesh's first device, in train mode)
    and in ``optimizer`` (over ``net``'s parameters)."""
    from ..train.losses import channel_losses

    _unet_only(net.spec)
    _, sp, devices = _grid(mesh)
    shard = data_sharding(mesh)

    def step(x, y, epoch=0):
        with f32_numerics():
            optimizer.zero_grad(set_to_none=True)
            lock = _Lockstep(net, devices)
            out = _gather(net.forward_shards(shard(x), lock, XSplit(sp)),
                          sp, devices[0])
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
    """Chunk-grid inference over the mesh: each batch gives one chunk to
    each ``data`` row, x-split over its ``space`` devices (the chunk's x
    must divide), run by the model's per-device eval replicas
    (``UNetModel.module``); the last batch is zero-padded. Returns the
    (C, z, y, x) float32 numpy features. Batch b+1 is dispatched before
    batch b is assembled on the host."""
    from ..core.chunks import chunk_slices, make_chunks

    dp, sp, devices = _grid(mesh)
    _unet_only(model.spec)
    nets = [model.module(d) for d in devices]
    volume = np.asarray(volume, dtype=np.float32)
    zyx = volume.shape[-3:]
    chunk_size = tuple(int(min(c, s)) for c, s in zip(chunk_size, zyx))
    starts, crops = make_chunks(zyx, chunk_size, margin)
    n = len(starts)
    out = np.zeros((model.out_channels,) + zyx, dtype=np.float32)

    def dispatch(b0):
        xb = np.zeros((dp, 1) + chunk_size, np.float32)
        for k in range(min(dp, n - b0)):
            xb[k, 0] = volume[chunk_slices(starts[b0 + k], chunk_size)]
        blocks = _blocks(torch.from_numpy(xb), dp, sp)
        return [y.float() for y in _eval_forward(nets, [
            blk.to(d).to(model.compute_dtype)
            for blk, d in zip(blocks, devices)], sp)]

    def assemble(ys, b0):
        for k in range(min(dp, n - b0)):
            i = b0 + k
            cr = (slice(None),) + tuple(slice(int(lo), int(hi))
                                        for lo, hi in crops[i])
            yk = np.concatenate([y[0].cpu().numpy()
                                 for y in ys[k * sp:(k + 1) * sp]], -1)
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
