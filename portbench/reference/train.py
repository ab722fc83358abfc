"""The first steps of iterseg's U-Net fine-tuning, in plain PyTorch.

One step: the U-Net in train mode on a batch of (z, y, x) chunks, the mean
binary cross-entropy over its 5 target channels (``torch.nn.BCELoss``: each
log clamped at -100, whose derivative is 0 where it is clamped), the
gradients by autograd, then Adam (betas 0.9, 0.999, eps 1e-8) applied
twice with the same gradients, as iterseg's trainer steps its optimiser
twice. Returns each step's loss, the first step's gradients and the
learnt leaves after the last step.
"""
from __future__ import annotations

import torch

from . import unet
from .segment import tf32_mode

BETAS = (0.9, 0.999)
EPS = 1e-8


def _clamped_log(x):
    ok = x > 0
    log = torch.log(torch.where(ok, x, torch.ones_like(x)))
    return torch.where(ok & (log > -100), log, torch.full_like(x, -100.0))


def check_loss(name):
    """Refuse a loss the reference does not compute."""
    if name != "BCELoss":
        raise ValueError(f"loss {name!r}: the reference computes BCELoss")


def bce(x, y, half=False):
    """Mean BCE; ``half`` takes the mean over the first half of x only
    (a planted fault: half of the batch left out)."""
    if half:
        w = x.shape[-1] // 2
        x, y = x[..., :w], y[..., :w]
    return torch.mean(-(y * _clamped_log(x) + (1 - y) * _clamped_log(1 - x)))


def adam(p, m, v, grads, t, lr):
    """One step of Adam over the dicts, in place (torch's update:
    ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``)."""
    b1, b2 = BETAS
    with torch.no_grad():
        for k, g in grads.items():
            m[k].mul_(b1).add_(g, alpha=1 - b1)
            v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(EPS)
            p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))


def run_steps(params, chunks, lr=0.01, double_step=True, tf32=False,
              half=False):
    """``chunks``: [(x (n, z, y, x), y (n, c, z, y, x))] tensors, one batch
    a step (BatchNorm over the batch, the loss its mean).
    ``params`` is updated in place. Returns (losses, first gradients)."""
    names = unet.trainable(params)
    m = {k: torch.zeros_like(params[k]) for k in names}
    v = {k: torch.zeros_like(params[k]) for k in names}
    losses, first, t = [], None, 0
    with tf32_mode(tf32):
        for x, y in chunks:
            leaves = {k: params[k].detach().requires_grad_(True)
                      for k in names}
            p = dict(params, **leaves)
            loss = bce(unet.forward(p, x[:, None], train=True), y, half)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names])))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            for _ in range(2 if double_step else 1):
                t += 1
                adam(params, m, v, grads, t, lr)
    return losses, first
