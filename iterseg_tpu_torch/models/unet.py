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
  with the leaf layers applied through a function the caller may give
  (``parallel.mesh`` runs data-parallel training through it);
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

import torch
import torch.nn as nn
import torch.nn.functional as F

DOWN_FACTORS = (1, 2, 2)
NEW_DOWN = (2, 2, 2)
ENCODER_CHANNELS = (32, 64, 128, 256, 256)
DECODER_IN_OUT = ((512, 128), (256, 64), (128, 32))
BN_EPS = 1e-5

__all__ = ["UNetSpec", "ConvModule", "UNet", "forked_unet_spec"]


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


def _bn_eval(x, bn: nn.BatchNorm3d):
    """Eval BatchNorm in the JAX model's folded form (same rounding)."""
    inv = torch.rsqrt(bn.running_var.float() + BN_EPS)
    scale = (bn.weight * inv).to(x.dtype).reshape(1, -1, 1, 1, 1)
    shift = (bn.bias - bn.running_mean * bn.weight * inv).to(x.dtype)
    return x * scale + shift.reshape(1, -1, 1, 1, 1)


class BatchNorm(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` whose eval forward is ``_bn_eval``; in train mode
    it takes the batch statistics as ``nn.BatchNorm3d`` does."""

    def forward(self, x):
        return super().forward(x) if self.training else _bn_eval(x, self)


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


def each_shard(m: nn.Module, xs):
    """The default layer function of ``forward_shards``: the leaf module
    ``m`` on each shard."""
    return [m(x) for x in xs]


class ConvModule(nn.Module):
    """(conv3d → BN → ReLU) × 2 with a configurable final activation."""

    def __init__(self, cin, cout, final="relu"):
        super().__init__()
        self.conv0 = nn.Conv3d(cin, cout, 3, 1, 1)
        self.conv1 = nn.Conv3d(cout, cout, 3, 1, 1)
        self.batch0 = BatchNorm(cout)
        self.batch1 = BatchNorm(cout)
        self.final = final

    def forward(self, x):
        return self.forward_shards([x])[0]

    def forward_shards(self, xs, layer=each_shard):
        """The block over a batch split into shards (see
        ``UNet.forward_shards``)."""
        xs = [torch.relu(x) for x in layer(self.batch0,
                                           layer(self.conv0, xs))]
        xs = layer(self.batch1, layer(self.conv1, xs))
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

    @staticmethod
    def _pool(x, factors):
        return F.max_pool3d(x, factors, factors, padding=(0, 1, 1))

    def forward(self, x):
        return self.forward_shards([x])[0]

    def forward_shards(self, xs, layer=each_shard):
        """The forward of a batch split into shards (a list of NCZYX
        tensors; one output each), layer by layer across the shards.
        ``layer(m, xs)`` applies each leaf module ``m`` (a ``Conv3d``, a
        ``BatchNorm`` or an ``Upsample``) to every shard: by default the
        module itself on each (``each_shard``); ``parallel.mesh`` passes
        one that gives each shard its device's parameters and takes the
        BatchNorm statistics over all the shards."""
        def block(m, xs):
            return m.forward_shards(xs, layer)

        def pool(xs, factors):
            return [self._pool(x, factors) for x in xs]

        def up_cat(m, xs, crop, skips):
            return [torch.cat([x[crop], s], 1)
                    for x, s in zip(layer(m, xs), skips)]

        inner = (Ellipsis, slice(None, -1), slice(None, -1))
        outer = (Ellipsis, slice(1, -1), slice(1, -1))
        c0 = block(self.c0, xs)
        c1 = block(self.c1, pool(c0, DOWN_FACTORS))
        c2 = block(self.c2, pool(c1, DOWN_FACTORS))
        c3 = block(self.c3, pool(c2, DOWN_FACTORS))
        enc = block(self.c4, pool(c3, NEW_DOWN))
        forks = []
        for i in range(len(self.spec.out_channels)):
            x = block(getattr(self, f"c5_{i}"),
                      up_cat(self.up0, enc, inner, c3))
            x = block(getattr(self, f"c6_{i}"),
                      up_cat(self.up1, x, inner, c2))
            x = block(getattr(self, f"c7_{i}"),
                      up_cat(self.up2, x, inner, c1))
            forks.append(block(getattr(self, f"c8_{i}"),
                               up_cat(self.up3, x, outer, c0)))
        if len(forks) == 1:
            return forks[0]
        return [torch.cat(parts, 1) for parts in zip(*forks)]


def forked_unet_spec(in_channels=1, fork_channels=(8, 2)):
    """The spec of a ForkedUNet: one encoder, a decoder per entry of
    ``fork_channels`` (iterseg ``unet.py:371-395``)."""
    return UNetSpec(in_channels=in_channels, out_channels=tuple(fork_channels))
