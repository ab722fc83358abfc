"""The FLOP counter equals a count by hooks on the program's U-Net."""
import math

import pytest
import torch

from counts.unet_flops import forward_flops, train_step_flops, layers


def _hook_count(net, x):
    total = []

    def hook(m, inp, out):
        if isinstance(m, torch.nn.ConvTranspose3d):
            macs = inp[0].numel() * m.out_channels // m.groups
        else:
            macs = out.numel() * m.in_channels // m.groups
        total.append(2 * macs * math.prod(m.kernel_size))

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d))]
    with torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("zyx", [(10, 64, 64), (2, 32, 48), (10, 48, 80)])
def test_forward_count_equals_hooks(zyx):
    from iterseg_tpu_torch.models.unet import UNet

    assert forward_flops(zyx) == _hook_count(UNet(), torch.zeros((1, 1) +
                                                                 zyx))


def test_train_step_count():
    rows = layers((10, 256, 256))
    fwd = forward_flops((10, 256, 256))
    assert train_step_flops((10, 256, 256)) == 3 * fwd - 2 * rows[0][1]
    # the counts PERF.md states
    assert fwd == 369_887_127_040
    assert 36 * fwd == 13_315_936_573_440
    assert train_step_flops((10, 256, 256)) == 1_108_528_919_040
