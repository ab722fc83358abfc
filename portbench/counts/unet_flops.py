"""Floating-point operations of iterseg's U-Net, counted from shapes.

Two operations per multiply-add of every convolution and transposed
convolution; BatchNorm, activations, pools and the loss are not counted.
A 3x3x3 conv with ``cin`` inputs makes ``27 cin`` multiply-adds an output
value; a depthwise transposed conv with kernel = stride makes one.
"""
from __future__ import annotations

import math


def _pool(shape, k):
    # max pool, kernel = stride = k, padding (0, 1, 1)
    pads = (0, 1, 1)
    return tuple((n + 2 * p - f) // f + 1 for n, f, p in zip(shape, k, pads))


def layers(zyx, encoder=(32, 64, 128, 256, 256), out_channels=5,
           in_channels=1):
    """One entry per conv of a (1, in_channels, *zyx) forward:
    ``(name, multiply-adds, first)``, ``first`` marking the conv whose
    input is the network's input."""
    pools = ((1, 2, 2), (1, 2, 2), (1, 2, 2), (2, 2, 2))
    shapes, rows, cin, shape = [], [], in_channels, tuple(zyx)
    for i, c in enumerate(encoder):
        if i:
            shape = _pool(shape, pools[i - 1])
        vox = math.prod(shape)
        rows.append((f"c{i}.conv0", vox * c * 27 * cin, i == 0))
        rows.append((f"c{i}.conv1", vox * c * 27 * c, False))
        shapes.append(shape)
        cin = c
    decoder = ((encoder[3] * 2, 128), (256, 64), (128, 32),
               (64, out_channels))
    ups = ((2, 2, 2), (1, 2, 2), (1, 2, 2), (1, 2, 2))
    h_ch = encoder[4]
    for j, ((dec_in, dec_out), k) in enumerate(zip(decoder, ups)):
        skip = shapes[3 - j]
        up_shape = tuple(n * f for n, f in zip(shape, k))
        rows.append((f"up{j}", math.prod(up_shape) * h_ch, False))
        vox = math.prod(skip)
        rows.append((f"c{5 + j}_0.conv0", vox * dec_out * 27 * dec_in, False))
        rows.append((f"c{5 + j}_0.conv1", vox * dec_out * 27 * dec_out,
                     False))
        shape, h_ch = skip, dec_out
    return rows


def forward_flops(zyx, **kw) -> int:
    """Forward FLOPs of one chunk."""
    return 2 * sum(m for _, m, _ in layers(zyx, **kw))


def train_step_flops(zyx, **kw) -> int:
    """FLOPs of one train step on one chunk: the forward, the input
    gradients of every conv but the first (whose input needs none) and the
    weight gradients of every conv, each as many multiply-adds as its
    forward."""
    rows = layers(zyx, **kw)
    macs = sum(m for _, m, _ in rows)
    return 2 * (3 * macs - sum(m for _, m, first in rows if first))
