"""Floating-point operations of Swin UNETR's forward (MONAI ``SwinUNETR``
v1), counted from shapes.

Two operations per multiply-add of every convolution, transposed
convolution, linear layer and attention product; norms, activations, the
softmax and the bias and mask adds are not counted. The linear layers run
where MONAI runs them: ``qkv`` and ``proj`` on the window-padded tokens,
the MLP on the stage's tokens, patch merging on the merged ones. A conv
with kernel k makes ``cin k^3`` multiply-adds an output value; a 2^3
transposed conv with stride 2 makes ``cout 8`` an input value.
"""
from __future__ import annotations

import math

from .window_attention import flops as attention_flops
from .window_attention import launches


def layers(chunk, feature_size=48, in_channels=1, out_channels=5,
           depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=7,
           patch_size=2, mlp_ratio=4):
    """One ``(name, multiply-adds)`` per layer of a (1, in_channels, *chunk)
    forward."""
    f = feature_size
    full = math.prod(chunk)
    dims = [c // patch_size for c in chunk]
    rows = [("patch_embed", math.prod(dims) * f * in_channels
             * patch_size ** 3)]
    vox = [math.prod(dims)]
    for i, depth in enumerate(depths):
        c = f * 2 ** i
        tokens = math.prod(dims)
        win = [min(d, window_size) for d in dims]
        padded = math.prod(-(-d // w) * w for d, w in zip(dims, win))
        for b in range(depth):
            rows += [(f"stage{i}.{b}.qkv", padded * c * 3 * c),
                     (f"stage{i}.{b}.proj", padded * c * c),
                     (f"stage{i}.{b}.mlp", 2 * tokens * c * mlp_ratio * c)]
        dims = [-(-d // 2) for d in dims]
        rows.append((f"stage{i}.merge", math.prod(dims) * 8 * c * 2 * c))
        vox.append(math.prod(dims))
    for k, (w, h, n, width) in enumerate(launches(
            chunk, f, num_heads, depths, window_size, patch_size)):
        rows.append((f"attention{k}", attention_flops(w, h, n, width) // 2))

    def res(name, v, cin, cout):
        rows.append((name + ".conv1", v * cout * cin * 27))
        rows.append((name + ".conv2", v * cout * cout * 27))
        if cin != cout:
            rows.append((name + ".conv3", v * cout * cin))

    res("encoder1", full, in_channels, f)
    res("encoder2", vox[0], f, f)
    res("encoder3", vox[1], 2 * f, 2 * f)
    res("encoder4", vox[2], 4 * f, 4 * f)
    res("encoder10", vox[4], 16 * f, 16 * f)
    ups = (("decoder5", 16 * f, 8 * f, vox[4], vox[3]),
           ("decoder4", 8 * f, 4 * f, vox[3], vox[2]),
           ("decoder3", 4 * f, 2 * f, vox[2], vox[1]),
           ("decoder2", 2 * f, f, vox[1], vox[0]),
           ("decoder1", f, f, vox[0], full))
    for name, cin, cout, v_in, v_out in ups:
        rows.append((name + ".transp_conv", v_in * cin * cout * 8))
        res(name + ".conv_block", v_out, 2 * cout, cout)
    rows.append(("out", full * out_channels * f))
    return rows


def forward_flops(chunk, **widths) -> int:
    """Forward FLOPs of one chunk."""
    return 2 * sum(m for _, m in layers(chunk, **widths))
