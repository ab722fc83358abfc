"""Swin UNETR (MONAI ``SwinUNETR`` v1) as a torch ``nn.Module``.

Hatamizadeh et al., "Swin UNETR: Swin Transformers for Semantic
Segmentation of Brain Tumors in MRI Images" (arXiv:2201.01266), as MONAI
implements it in ``monai/networks/nets/swin_unetr.py`` with
``downsample="merging"``, ``use_v2=False``, ``normalize=True``, instance
norm and no dropout. The module's parameter and buffer names are MONAI's,
so a MONAI state dict (``swinViT.patch_embed.proj.weight``,
``swinViT.layers1.0.blocks.1.attn.relative_position_bias_table``,
``encoder1.layer.conv3.conv.weight``, ``decoder5.transp_conv.conv.weight``,
``out.conv.conv.bias`` ...) loads strictly. One departure: iterseg's
sigmoid on the outputs, as the U-Net's heads have.

Tensors are NCDHW; F is ``feature_size``. The stem is a 2^3 patch conv;
stage i (C = F 2^i, ``num_heads[i]`` heads) runs ``depths[i]`` blocks of
LayerNorm, shifted-window attention (``ops.window_attention``: windows of
7^3, the odd blocks rolled by 3, an axis of at most 7 taking its size as
window and no shift), a residual, LayerNorm, a GELU MLP of width 4C and a
residual, then patch merging (MONAI v1's 8-slice order, with two slices
repeated, which pretrained MONAI weights assume) to 2C channels at half
size. Each stage input and the last output, LayerNormed without weights,
are the skips of a residual-conv decoder (InstanceNorm, LeakyReLU 0.01,
full transposed convs).

The input's axes must be multiples of 32 (``SwinUNETRSpec.chunk_multiples``:
the patch and four halvings). Inference only: the window-attention kernel
has no backward. Run the f32 forward inside ``device.f32_numerics()``.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.window_attention import (FULL_WINDOW, relative_index,
                                    window_attention)

__all__ = ["SwinUNETRSpec", "SwinUNETR", "is_swin_unetr", "spec_from_params"]

PATCH = 2
WINDOW = FULL_WINDOW
SHIFT = tuple(w // 2 for w in WINDOW)
MLP_RATIO = 4
LN_EPS = 1e-5
LEAKY_SLOPE = 0.01
# a key only a Swin UNETR state dict holds
SWIN_KEY = "swinViT.patch_embed.proj.weight"


def is_swin_unetr(params) -> bool:
    """Whether a flat parameter dict is a Swin UNETR's (by its key names)."""
    return SWIN_KEY in params


class SwinUNETRSpec:
    """Static configuration: channels in and out, ``feature_size``, blocks
    and heads per stage."""

    chunk_multiples = (32, 32, 32)

    def __init__(self, in_channels=1, out_channels=5, feature_size=48,
                 depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24)):
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.feature_size = int(feature_size)
        self.depths = tuple(int(d) for d in depths)
        self.num_heads = tuple(int(h) for h in num_heads)

    def _key(self):
        return (self.in_channels, self.out_channels, self.feature_size,
                self.depths, self.num_heads)

    def __eq__(self, other):
        return isinstance(other, SwinUNETRSpec) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return "SwinUNETRSpec(%d, %d, feature_size=%d, depths=%s, " \
            "num_heads=%s)" % self._key()

    @property
    def total_out(self):
        return self.out_channels

    def activation_bytes(self, chunk) -> int:
        """Activation bytes of one chunk in a forward, for the microbatch
        budget: the widest full-resolution tensor (the last decoder's 2F
        channels of transposed conv and skip), float32, x4 for the copies
        alive beside it (the ``enc0`` skip, conv outputs, norms)."""
        return int(np.prod(chunk)) * 2 * self.feature_size * 4 * 4


def spec_from_params(params) -> SwinUNETRSpec:
    """The spec of a Swin UNETR state dict, from its array shapes."""
    emb = params[SWIN_KEY].shape  # (F, in, 2, 2, 2)
    depths, heads = [], []
    for i in range(1, 5):
        prefix = f"swinViT.layers{i}.0.blocks."
        n = 0
        while f"{prefix}{n}.norm1.weight" in params:
            n += 1
        depths.append(n)
        heads.append(params[f"{prefix}0.attn.relative_position_bias_table"]
                     .shape[1])
    return SwinUNETRSpec(emb[1], params["out.conv.conv.weight"].shape[0],
                         emb[0], depths, heads)


def _conv(cin, cout, k, bias=False, transposed=False):
    """MONAI's ``get_conv_layer``: a ``Convolution`` holding ``conv``."""
    cls = nn.ConvTranspose3d if transposed else nn.Conv3d
    pad = 0 if transposed else (k - 1) // 2
    return nn.Sequential(OrderedDict(conv=cls(cin, cout, k, stride=k if
                                              transposed else 1,
                                              padding=pad, bias=bias)))


def _instance_norm(x):
    return F.instance_norm(x, eps=LN_EPS)


class ResBlock(nn.Module):
    """MONAI ``UnetResBlock`` (kernel 3, stride 1, instance norm)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3)
        self.conv2 = _conv(cout, cout, 3)
        if cin != cout:
            self.conv3 = _conv(cin, cout, 1)

    def forward(self, x):
        o = F.leaky_relu(_instance_norm(self.conv1(x)), LEAKY_SLOPE)
        o = _instance_norm(self.conv2(o))
        r = _instance_norm(self.conv3(x)) if hasattr(self, "conv3") else x
        return F.leaky_relu(o + r, LEAKY_SLOPE)


class BasicBlock(nn.Module):
    """MONAI ``UnetrBasicBlock`` with ``res_block=True``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.layer = ResBlock(cin, cout)

    def forward(self, x):
        return self.layer(x)


class UpBlock(nn.Module):
    """MONAI ``UnetrUpBlock``: a 2^3 transposed conv, the skip
    concatenated, a ``UnetResBlock``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.transp_conv = _conv(cin, cout, 2, transposed=True)
        self.conv_block = ResBlock(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], 1))


class OutBlock(nn.Module):
    """MONAI ``UnetOutBlock``: a 1^3 conv with bias."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _conv(cin, cout, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class WindowAttention(nn.Module):
    """MONAI ``WindowAttention`` parameters: the qkv and output
    projections, the bias table and MONAI's (persistent) index buffer."""

    def __init__(self, dim, heads):
        super().__init__()
        self.num_heads = heads
        rows = math.prod(2 * w - 1 for w in WINDOW)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(rows, heads))
        self.register_buffer("relative_position_index",
                             relative_index(math.prod(WINDOW)))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    """MONAI ``MLPBlock`` (GELU by erf)."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


def window_and_shift(dims, shifted):
    """MONAI ``get_window_size``: an axis of at most 7 takes its size as
    window and no shift."""
    window = tuple(min(d, w) for d, w in zip(dims, WINDOW))
    shift = tuple(0 if d <= w or not shifted else s
                  for d, w, s in zip(dims, WINDOW, SHIFT))
    return window, shift


class SwinBlock(nn.Module):
    """MONAI ``SwinTransformerBlock`` on channels-last tokens
    (B, D, H, W, C)."""

    def __init__(self, dim, heads, shifted):
        super().__init__()
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim)

    def forward(self, x):
        b, d, h, w, c = x.shape
        window, shift = window_and_shift((d, h, w), self.shifted)
        pads = [(-n) % k for n, k in zip((d, h, w), window)]
        y = F.pad(self.norm1(x), (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        attn = self.attn
        o = window_attention(attn.qkv(y).contiguous(),
                             attn.relative_position_bias_table,
                             attn.num_heads, window, shift)
        x = x + attn.proj(o[:, :d, :h, :w])
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """MONAI ``PatchMerging`` (v1): 8 strided slices in v1's order (two of
    them repeated), LayerNorm(8C), Linear(8C -> 2C) without bias."""

    ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
             (0, 1, 0), (0, 0, 1), (1, 1, 1))

    def __init__(self, dim):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS)

    def forward(self, x):
        b, d, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in self.ORDER], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """MONAI ``BasicLayer``: the stage's blocks (every other one shifted)
    and its patch merging."""

    def __init__(self, dim, depth, heads):
        super().__init__()
        self.blocks = nn.ModuleList(
            [SwinBlock(dim, heads, shifted=i % 2 == 1) for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.proj = nn.Conv3d(cin, dim, PATCH, stride=PATCH)

    def forward(self, x):
        return self.proj(x)


class SwinTransformer(nn.Module):
    """MONAI ``SwinTransformer`` (v1): the patch embedding and the four
    stages; returns the five skips, each LayerNormed over channels without
    weights (``normalize=True``), NCDHW."""

    def __init__(self, spec: SwinUNETRSpec):
        super().__init__()
        f = spec.feature_size
        self.patch_embed = PatchEmbed(spec.in_channels, f)
        for i, (depth, heads) in enumerate(zip(spec.depths, spec.num_heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList(
                [BasicLayer(f * 2 ** i, depth, heads)]))

    @staticmethod
    def _normalised(x):
        """Channels-last tokens LayerNormed, as NCDHW."""
        return F.layer_norm(x, x.shape[-1:], eps=LN_EPS).permute(0, 4, 1, 2, 3)

    def forward(self, x):
        h = self.patch_embed(x).permute(0, 2, 3, 4, 1)
        outs = [self._normalised(h)]
        for i in range(1, 5):
            h = getattr(self, f"layers{i}")[0](h)
            outs.append(self._normalised(h))
        return outs


class SwinUNETR(nn.Module):
    """MONAI ``SwinUNETR`` v1 with sigmoid outputs. NCDHW in and out."""

    def __init__(self, spec: SwinUNETRSpec = None):
        super().__init__()
        self.spec = spec if spec is not None else SwinUNETRSpec()
        f, cin = self.spec.feature_size, self.spec.in_channels
        self.swinViT = SwinTransformer(self.spec)
        self.encoder1 = BasicBlock(cin, f)
        self.encoder2 = BasicBlock(f, f)
        self.encoder3 = BasicBlock(2 * f, 2 * f)
        self.encoder4 = BasicBlock(4 * f, 4 * f)
        self.encoder10 = BasicBlock(16 * f, 16 * f)
        self.decoder5 = UpBlock(16 * f, 8 * f)
        self.decoder4 = UpBlock(8 * f, 4 * f)
        self.decoder3 = UpBlock(4 * f, 2 * f)
        self.decoder2 = UpBlock(2 * f, f)
        self.decoder1 = UpBlock(f, f)
        self.out = OutBlock(f, self.spec.out_channels)
        self.eval()

    def init_weights(self, seed: int = 0) -> "SwinUNETR":
        """Fresh weights in MONAI's initial distributions: torch's defaults
        for convs and linears (weights and biases uniform in
        +-1/sqrt(fan-in), fan-in ``weight.shape[1] x prod(kernel)``), the
        bias tables normal with std 0.02 (truncated at +-2), LayerNorm
        weight 1 and bias 0. Drawn from a CPU ``torch.Generator`` seeded by
        ``seed``."""
        gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
        params = dict(self.named_parameters())
        with torch.no_grad():
            for name, p in params.items():
                if name.endswith("relative_position_bias_table"):
                    p.normal_(0.0, 0.02, generator=gen).clamp_(-2.0, 2.0)
                elif ".norm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                else:
                    shape = params[name.rsplit(".", 1)[0] + ".weight"].shape
                    bound = 1.0 / math.sqrt(math.prod(shape[1:]))
                    p.uniform_(-bound, bound, generator=gen)
        return self

    def check_index(self):
        """Raise ``ValueError`` unless every block's
        ``relative_position_index`` is MONAI's (the kernel computes it
        rather than reading it)."""
        want = relative_index(math.prod(WINDOW))
        for name, buf in self.named_buffers():
            if name.endswith("relative_position_index") and not torch.equal(
                    buf.cpu(), want):
                raise ValueError(f"{name} is not MONAI's relative index")

    def forward(self, x):
        if any(n % m for n, m in zip(x.shape[2:],
                                     self.spec.chunk_multiples)):
            raise ValueError(f"Swin UNETR takes axes that are multiples of "
                             f"{self.spec.chunk_multiples}, got "
                             f"{tuple(x.shape[2:])}")
        hs = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hs[0])
        enc2 = self.encoder3(hs[1])
        enc3 = self.encoder4(hs[2])
        dec4 = self.encoder10(hs[4])
        dec3 = self.decoder5(dec4, hs[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        out = self.decoder1(dec0, enc0)
        return torch.sigmoid(self.out(out))
