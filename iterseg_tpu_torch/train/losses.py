"""Loss functions over NCZYX predictions, in torch.

The port of ``iterseg_tpu/train/losses.py``: BCELoss (torch's -100 log
clamp), DiceLoss (1 - Dice, smooth 1, channel mean), MSELoss, WeightedBCE,
EpochWeightedBCE, Channelwise, the channel-flattening helper and the
per-channel loss logging.

BCE is written out with the JAX package's double-where ``_safe_log`` and
not taken from ``F.binary_cross_entropy``: torch's backward there is
``(x - y) / max(x (1 - x), 1e-12)``, which is not zero where a sigmoid has
saturated to exactly 0 or 1 (it does after one real step), while the JAX
gradient is exactly zero in the clamped region.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = [
    "flatten_channels",
    "bce_loss",
    "mse_loss",
    "dice_loss",
    "weighted_bce_loss",
    "make_loss_function",
    "channel_losses",
]

_LOG_CLAMP = -100.0  # torch BCELoss clamps log terms at -100
# smallest normal f32: below it log underflows and 1/x overflows
_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def _safe_log(x):
    """log(x) clamped at -100 with a NaN/inf-free gradient: log(x) for
    normal x, -100 for subnormal or zero x, and an exact-zero gradient in
    the clamped region (the double-where form)."""
    tiny = x < _MIN_NORMAL
    return torch.where(tiny, _LOG_CLAMP,
                       torch.log(torch.where(tiny, 1.0, x)))


def flatten_channels(inputs, targets, channel_dim=1):
    """(N, C, z, y, x) -> (C, N*z*y*x) for both tensors."""
    order = [channel_dim] + [i for i in range(inputs.ndim)
                             if i != channel_dim]
    inputs = inputs.permute(order).reshape(inputs.shape[channel_dim], -1)
    targets = targets.permute(order).reshape(targets.shape[channel_dim], -1)
    return inputs, targets


def _bce_elementwise(x, y):
    return -(y * _safe_log(x) + (1.0 - y) * _safe_log(1.0 - x))


def bce_loss(inputs, targets):
    """torch ``nn.BCELoss()`` values (mean reduction, log clamp)."""
    return torch.mean(_bce_elementwise(inputs, targets))


def mse_loss(inputs, targets):
    return torch.mean((inputs - targets) ** 2)


def dice_loss(inputs, targets, channel_dim=1, smooth=1.0):
    """1 - Dice, per channel, then the mean."""
    inputs, targets = flatten_channels(inputs, targets, channel_dim)
    intersection = torch.sum(inputs * targets, dim=-1)
    dice = (2.0 * intersection + smooth) / (
        torch.sum(inputs, dim=-1) + torch.sum(targets, dim=-1) + smooth)
    return torch.mean(1.0 - dice)


def weighted_bce_loss(inputs, targets, chan_weights, channel_dim=1,
                      reduction="mean", final_reduction="mean"):
    """Per-channel-weighted BCE."""
    inputs, targets = flatten_channels(inputs, targets, channel_dim)
    unreduced = _bce_elementwise(inputs, targets)
    if reduction == "mean":
        channel_losses_ = torch.mean(unreduced, dim=-1) * chan_weights
    elif reduction == "sum":
        channel_losses_ = torch.sum(unreduced, dim=-1) * chan_weights
    else:
        raise ValueError("reduction param must be mean or sum")
    if final_reduction == "mean":
        return torch.mean(channel_losses_)
    if final_reduction == "sum":
        return torch.sum(channel_losses_)
    raise ValueError("final_reduction must be mean or sum")


def _weights_on(chan_weights):
    """``w(device)``: the f32 channel weights on ``device``, copied there
    once."""
    host = torch.as_tensor(np.asarray(chan_weights, np.float32))
    on = {}

    def w(device):
        if device not in on:
            on[device] = host.to(device)
        return on[device]

    return w


def make_loss_function(loss_function: str, chan_weights=None, losses=None,
                       chan_losses=None) -> Callable:
    """Resolve a loss by name. Returns ``f(y_hat, y, epoch=0)``; the epoch
    only matters for ``'EpochWeightedBCE'`` (a row of channel weights per
    epoch)."""
    if loss_function == "BCELoss":
        return lambda y_hat, y, epoch=0: bce_loss(y_hat, y)
    if loss_function in ("DiceLoss", "DICELoss"):
        return lambda y_hat, y, epoch=0: dice_loss(y_hat, y)
    if loss_function == "MSELoss":
        return lambda y_hat, y, epoch=0: mse_loss(y_hat, y)
    if loss_function == "WeightedBCE":
        w = _weights_on(chan_weights)
        return lambda y_hat, y, epoch=0: weighted_bce_loss(
            y_hat, y, w(y_hat.device))
    if loss_function == "EpochWeightedBCE":
        w = _weights_on(chan_weights)  # (epochs, C)
        return lambda y_hat, y, epoch=0: weighted_bce_loss(
            y_hat, y, w(y_hat.device)[epoch])
    if loss_function == "Channelwise":
        fns = [make_loss_function(l) if isinstance(l, str) else l
               for l in losses]
        chans = list(chan_losses)

        def channelwise(y_hat, y, epoch=0):
            vals = []
            for fn, c in zip(fns, chans):
                s_ = [slice(None)] * y_hat.ndim
                s_[1] = c
                s_ = tuple(s_)
                vals.append(fn(y_hat[s_], y[s_]))
            return torch.mean(torch.stack(vals))

        return channelwise
    raise ValueError(
        "Valid loss options are BCELoss, WeightedBCE, EpochWeightedBCE, "
        "Channelwise, MSELoss and DiceLoss"
    )


def channel_losses(y_hat, y, loss_fn, n_channels, epoch=0):
    """Per-channel scalar losses for logging: the loss applied to each
    channel slice ``y_hat[:, i]``, which is 4D, so a loss that flattens
    channels (Dice) takes z as its channel axis there, as in the JAX
    package."""
    return [loss_fn(y_hat[:, i, ...], y[:, i, ...], epoch)
            for i in range(n_channels)]
