"""Anisotropic 3D U-Net as a torch ``nn.Module``.

The port of ``iterseg_tpu/models/unet.py``: the same architecture over the
same flat ``state_dict`` keys (``c0.conv0.weight`` ...), so
``iterseg_tpu/data/default_unet.npz`` and reference ``.pt`` checkpoints load
unchanged. Invariants kept exactly:

- four MaxPool3d stages with stride (1,2,2) and padding (0,1,1) — the
  256→129→65→33→17 ladder — with the bottom pool forced to (2,2,2);
- encoder channels 1→32→64→128→256→256; decoder 512→128, 256→64, 128→32,
  64→out, sigmoid heads by default;
- grouped ConvTranspose3d upsampling with kernel == stride, evaluated as the
  exact broadcast product the JAX model uses (one multiply and one add per
  output, no reduction);
- the decoder crops ``[..., :-1, :-1]`` and ``[..., 1:-1, 1:-1]``;
- any number of decoder forks sharing one encoder;
- one forward, ``UNet.forward_shards``, over a batch split into shards,
  with the leaf layers applied through a function the caller may give and
  each row of ``space`` shards splitting the x axis (``XSplit``);
  ``parallel.mesh`` runs its data and space meshes through it, and
  ``UNet.forward`` is its one-shard case;
- eval BatchNorm folded to ``x * scale + shift`` exactly as the JAX model
  computes it; in train mode (``net.train()``) ``nn.BatchNorm3d``'s batch
  statistics: the biased variance normalises, and the running stats move
  with momentum 0.1 towards the batch mean and the unbiased variance
  (``batchnorm_train`` in the JAX model);
- ``init_weights(seed)``: the distributions of the JAX ``init_params``.

The convolutions are ``torch.nn.functional.conv3d`` (cuDNN on the GPU); the
JAX package runs them as XLA, not Pallas, so they are not kernels to port.
Run the f32 forward inside ``device.f32_numerics()``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

DOWN_FACTORS = (1, 2, 2)
NEW_DOWN = (2, 2, 2)
ENCODER_CHANNELS = (32, 64, 128, 256, 256)
DECODER_IN_OUT = ((512, 128), (256, 64), (128, 32))
BN_EPS = 1e-5

__all__ = ["UNetSpec", "ConvModule", "UNet", "XSplit", "split_bounds",
           "forked_unet_spec"]


class UNetSpec:
    """Static configuration of the network (forks, channels, heads)."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: Union[int, Tuple[int, ...]] = 5,
        chan_final_activations: Optional[Sequence[str]] = None,
    ):
        self.in_channels = in_channels
        self.forked = isinstance(out_channels, (tuple, list))
        self.out_channels = (
            tuple(out_channels) if self.forked else (out_channels,)
        )
        if chan_final_activations is None:
            self.finals = tuple("sigmoid" for _ in self.out_channels)
        else:
            self.finals = tuple(chan_final_activations)

    def __eq__(self, other):
        return (isinstance(other, UNetSpec)
                and (self.in_channels, self.out_channels, self.finals,
                     self.forked)
                == (other.in_channels, other.out_channels, other.finals,
                    other.forked))

    def __hash__(self):
        return hash((self.in_channels, self.out_channels, self.finals,
                     self.forked))

    @property
    def total_out(self):
        return sum(self.out_channels)

    # the chunk axes the network takes: z even, y and x multiples of 16
    chunk_multiples = (2, 16, 16)

    def activation_bytes(self, chunk) -> int:
        """Activation bytes of one chunk in a forward, for the microbatch
        budget: 32 channels at full resolution, float32, x4 for the
        encoder and decoder copies."""
        return int(np.prod(chunk)) * 32 * 4 * 4


def _final_activation(x, kind):
    if kind == "relu":
        return torch.relu(x)
    if kind == "softmax":
        return torch.softmax(x, dim=1)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown final activation {kind!r}")


def _bn_fold(bn: nn.BatchNorm3d, dtype):
    """Eval BatchNorm's ``(scale, shift)`` in the JAX model's folded form
    (same rounding), shaped to broadcast over NCZYX."""
    inv = torch.rsqrt(bn.running_var.float() + BN_EPS)
    scale = (bn.weight * inv).to(dtype).reshape(1, -1, 1, 1, 1)
    shift = (bn.bias - bn.running_mean * bn.weight * inv).to(dtype)
    return scale, shift.reshape(1, -1, 1, 1, 1)


class BatchNorm(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` whose eval forward is ``x * scale + shift`` in
    the JAX model's folded form; in train mode it takes the batch
    statistics as ``nn.BatchNorm3d`` does.

    Outside autograd the fold is kept, one for each CUDA stream it is used
    on (so no stream reads what another computes), until a train-mode
    forward moves the statistics or the weights or statistics change
    (another tensor, or written in place other than through ``.data``):
    an eval forward then launches two kernels a BatchNorm instead of
    eight."""

    def __init__(self, channels):
        super().__init__(channels)
        self._folds, self._fold_of = {}, None

    def _folded(self, dtype):
        if torch.is_grad_enabled():
            return _bn_fold(self, dtype)
        of = tuple((t.data_ptr(), t._version) for t in (
            self.weight, self.bias, self.running_mean, self.running_var))
        if of != self._fold_of:
            self._folds, self._fold_of = {}, of
        stream = (torch.cuda.current_stream(self.weight.device).stream_id
                  if self.weight.is_cuda else None)
        key = (stream, dtype)
        if key not in self._folds:
            self._folds[key] = _bn_fold(self, dtype)
        return self._folds[key]

    def forward(self, x):
        if self.training:
            # moves the running statistics without a version of its own
            self._folds = {}
            return super().forward(x)
        scale, shift = self._folded(x.dtype)
        return x * scale + shift


class Upsample(nn.ConvTranspose3d):
    """Depthwise ConvTranspose3d with kernel == stride, evaluated as the
    broadcast product of the JAX model:
    out[n,c,z*fz+dz,y*fy+dy,x*fx+dx] = x[n,c,z,y,x]*w[c,0,dz,dy,dx] + b."""

    def __init__(self, channels, factors):
        super().__init__(channels, channels, factors, stride=factors,
                         groups=channels)

    def forward(self, x):
        n, c, z, y, xx = x.shape
        fz, fy, fx = self.stride
        wk = self.weight.reshape(1, c, 1, fz, 1, fy, 1, fx).to(x.dtype)
        out = (x.reshape(n, c, z, 1, y, 1, xx, 1) * wk).reshape(
            n, c, z * fz, y * fy, xx * fx)
        return out + self.bias.reshape(1, -1, 1, 1, 1).to(x.dtype)


class Conv(nn.Conv3d):
    """The 3x3x3 ``Conv3d`` of a ``ConvModule``. With ``halo=True`` its
    input is a shard's slab that already holds one plane of x on each side
    (its neighbours' planes, or zeros at the global ends), so only z and y
    are padded and the output is two planes narrower; the slab of a shard
    that owns no plane gives an empty output without a call."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 3, 1, 1)

    def forward(self, x, halo=False):
        if not halo:
            return super().forward(x)
        n, _, z, y, width = x.shape
        if width <= 2:
            return x.new_zeros(n, self.out_channels, z, y, 0)
        return F.conv3d(x, self.weight, self.bias, padding=(1, 1, 0))


def each_shard(m: nn.Module, xs, **kw):
    """The default layer function of ``forward_shards``: the leaf module
    ``m`` on each shard (``kw`` goes to its forward)."""
    return [m(x, **kw) for x in xs]


def split_bounds(width: int, parts: int):
    """The balanced split of ``width`` x planes over ``parts`` shards:
    shard s owns ``[b[s], b[s + 1])`` (possibly empty) of the returned
    ``b``."""
    return [s * width // parts for s in range(parts + 1)]


class XSplit:
    """How ``forward_shards`` splits the x axis: the shards form rows of
    ``parts`` consecutive shards (the mesh's ``space`` extent), and at every
    level of the U-Net shard s of a row owns the planes ``split_bounds(W,
    parts)[s:s + 2]`` of that level's width W (W' = W // 2 + 1 under each
    pool: 256 -> 129 -> 65 -> 33 -> 17). Each op builds the planes it reads
    with ``fetch`` from the shards that own them: a conv one plane a side,
    a pool its windows' planes, an upsample the planes under its owned,
    cropped output. ``parts=1`` is one device's forward: every shard owns
    its whole width and each op runs as is."""

    def __init__(self, parts: int = 1):
        self.parts = int(parts)

    def rows(self, xs):
        """The shards row by row, with each row's bounds; a row whose
        widths are not the balanced split of their sum raises."""
        p = self.parts
        if len(xs) % p:
            raise ValueError(f"{len(xs)} shards do not form rows of {p}")
        for r in range(0, len(xs), p):
            row = xs[r:r + p]
            b = split_bounds(sum(x.shape[-1] for x in row), p)
            got = [x.shape[-1] for x in row]
            if got != [hi - lo for lo, hi in zip(b, b[1:])]:
                raise RuntimeError(f"shard widths {got} are not the "
                                   f"balanced split {b} of x")
            yield row, b

    @staticmethod
    def fetch(row, b, s, lo, hi, fill=None):
        """Planes ``[lo, hi)`` of a row's level on shard s's device: each
        owner's part moved by ``tensor.to`` (autograd carries its gradient
        back), and ``fill`` outside ``[0, W)``. The result may be a view
        of a shard: never write into it."""
        own = row[s]
        if hi <= lo:
            return own[..., :0]
        parts = []
        shape = own.shape[:-1]

        def pad(n):
            parts.append(torch.full(shape + (n,), fill, dtype=own.dtype,
                                    device=own.device))

        if lo < 0:
            pad(-lo)
        for x, a, c in zip(row, b, b[1:]):
            a2, c2 = max(a, lo), min(c, hi)
            if a2 < c2:
                parts.append(x[..., a2 - a:c2 - a].to(own.device))
        if hi > b[-1]:
            pad(hi - b[-1])
        return parts[0] if len(parts) == 1 else torch.cat(parts, -1)

    def conv(self, layer, m, xs):
        """A 3x3x3 conv (zero padding) of each shard's owned planes."""
        if self.parts == 1:
            return layer(m, xs)
        slabs = [self.fetch(row, b, s, b[s] - 1, b[s + 1] + 1, 0.0)
                 for row, b in self.rows(xs) for s in range(self.parts)]
        return layer(m, slabs, halo=True)

    def pool(self, xs, factors):
        """Max pool, kernel = stride = ``factors``, padding (0, 1, 1):
        output plane j reads input planes 2j - 1 and 2j."""
        if self.parts == 1:
            return [F.max_pool3d(x, factors, factors, padding=(0, 1, 1))
                    for x in xs]
        out = []
        for row, b in self.rows(xs):
            nb = split_bounds(b[-1] // 2 + 1, self.parts)
            for s, (lo, hi) in enumerate(zip(nb, nb[1:])):
                if hi == lo:
                    n, c, z, y, _ = row[s].shape
                    out.append(row[s].new_zeros(
                        n, c, z // factors[0], y // factors[1] + 1, 0))
                    continue
                slab = self.fetch(row, b, s, 2 * lo - 1, 2 * hi - 1,
                                  float("-inf"))
                out.append(F.max_pool3d(slab, factors, factors,
                                        padding=(0, 1, 0)))
        return out

    def up_cat(self, layer, m, xs, c, skips):
        """Upsample ``xs`` (``m``, kernel = stride, x factor 2), crop it
        to the skips' level (y and x ``[c:-1]``: ``inner`` c = 0, ``outer``
        c = 1) and concatenate each shard with its skip, which owns the
        same planes: output plane i is upsampled plane i + c, which reads
        input plane (i + c) // 2."""
        slabs, crops = [], []
        skip_rows = self.rows(skips)
        for row, b in self.rows(xs):
            _, sb = next(skip_rows)
            for s, (lo, hi) in enumerate(zip(sb, sb[1:])):
                a = (lo + c) // 2
                slabs.append(self.fetch(row, b, s, a, (hi + c + 1) // 2))
                crops.append(slice(lo + c - 2 * a, hi + c - 2 * a))
        return [torch.cat([u[..., c:-1, xc], sk], 1) for u, xc, sk in
                zip(layer(m, slabs), crops, skips)]


WHOLE = XSplit(1)


class ConvModule(nn.Module):
    """(conv3d → BN → ReLU) × 2 with a configurable final activation."""

    def __init__(self, cin, cout, final="relu"):
        super().__init__()
        self.conv0 = Conv(cin, cout)
        self.conv1 = Conv(cout, cout)
        self.batch0 = BatchNorm(cout)
        self.batch1 = BatchNorm(cout)
        self.final = final

    def forward(self, x):
        return self.forward_shards([x])[0]

    def forward_shards(self, xs, layer=each_shard, split=WHOLE):
        """The block over a batch split into shards (see
        ``UNet.forward_shards``)."""
        xs = [torch.relu(x) for x in layer(
            self.batch0, split.conv(layer, self.conv0, xs))]
        xs = layer(self.batch1, split.conv(layer, self.conv1, xs))
        return [_final_activation(x, self.final) for x in xs]


class UNet(nn.Module):
    """The iterseg U-Net (ForkedUNet when ``spec.forked``). NCZYX in and
    out. Built in eval mode; ``train()`` switches BatchNorm to batch
    statistics."""

    def __init__(self, spec: Optional[UNetSpec] = None):
        super().__init__()
        self.spec = spec if spec is not None else UNetSpec()
        cin = self.spec.in_channels
        for i, cout in enumerate(ENCODER_CHANNELS):
            setattr(self, f"c{i}", ConvModule(cin, cout))
            cin = cout
        for i, c in enumerate(self.spec.out_channels):
            for j, (dec_in, dec_out) in enumerate(DECODER_IN_OUT):
                setattr(self, f"c{5 + j}_{i}", ConvModule(dec_in, dec_out))
            setattr(self, f"c8_{i}",
                    ConvModule(64, c, final=self.spec.finals[i]))
        for name, c, k in (("up0", 256, NEW_DOWN), ("up1", 128, DOWN_FACTORS),
                           ("up2", 64, DOWN_FACTORS),
                           ("up3", 32, DOWN_FACTORS)):
            setattr(self, name, Upsample(c, k))
        self.eval()

    def init_weights(self, seed: int = 0) -> "UNet":
        """Fresh weights with the distributions of the JAX ``init_params``
        (torch's defaults): kaiming-uniform with a=sqrt(5) over fan-in,
        biases uniform in +-1/sqrt(fan-in), BatchNorm weight 1 and bias 0,
        running stats 0 and 1. A conv's fan-in is cin x prod(kernel); the
        grouped ``up*`` transposes, weight (C, 1, k...), take prod(kernel).
        Drawn from a CPU ``torch.Generator`` seeded by ``seed``, so call it
        before moving the module to a card. The draws are not those of
        ``jax.random``."""
        gen = torch.Generator().manual_seed(int(seed))
        a = 5.0 ** 0.5
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                    fan_in = m.weight[0].numel()
                    bound = (2.0 / (1 + a * a)) ** 0.5 * (3.0 / fan_in) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=gen)
                    b = 1.0 / fan_in ** 0.5
                    m.bias.uniform_(-b, b, generator=gen)
                elif isinstance(m, nn.BatchNorm3d):
                    m.reset_parameters()
        return self

    def forward(self, x):
        return self.forward_shards([x])[0]

    def forward_shards(self, xs, layer=each_shard, split=WHOLE):
        """The forward of a batch split into shards (a list of NCZYX
        tensors; one output each), layer by layer across the shards.
        ``layer(m, xs, **kw)`` applies each leaf module ``m`` (a ``Conv``,
        a ``BatchNorm`` or an ``Upsample``) to every shard: by default the
        module itself on each (``each_shard``); ``parallel.mesh`` passes
        one that gives each shard its device's parameters and takes the
        BatchNorm statistics over all the shards. ``split`` (an ``XSplit``)
        says how rows of shards share the x axis and routes the convs, the
        pools, and the upsamples with their crops and skip
        concatenations; by default each shard holds its whole x axis."""
        def block(m, xs):
            return m.forward_shards(xs, layer, split)

        c0 = block(self.c0, xs)
        c1 = block(self.c1, split.pool(c0, DOWN_FACTORS))
        c2 = block(self.c2, split.pool(c1, DOWN_FACTORS))
        c3 = block(self.c3, split.pool(c2, DOWN_FACTORS))
        enc = block(self.c4, split.pool(c3, NEW_DOWN))
        forks = []
        for i in range(len(self.spec.out_channels)):
            # the decoder crops: inner [..., :-1, :-1], outer [..., 1:-1, 1:-1]
            x = block(getattr(self, f"c5_{i}"),
                      split.up_cat(layer, self.up0, enc, 0, c3))
            x = block(getattr(self, f"c6_{i}"),
                      split.up_cat(layer, self.up1, x, 0, c2))
            x = block(getattr(self, f"c7_{i}"),
                      split.up_cat(layer, self.up2, x, 0, c1))
            forks.append(block(getattr(self, f"c8_{i}"),
                               split.up_cat(layer, self.up3, x, 1, c0)))
        if len(forks) == 1:
            return forks[0]
        return [torch.cat(parts, 1) for parts in zip(*forks)]


def forked_unet_spec(in_channels=1, fork_channels=(8, 2)):
    """The spec of a ForkedUNet: one encoder, a decoder per entry of
    ``fork_channels`` (iterseg ``unet.py:371-395``)."""
    return UNetSpec(in_channels=in_channels, out_channels=tuple(fork_channels))
