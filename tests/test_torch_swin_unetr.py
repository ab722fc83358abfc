"""Swin UNETR in the port (``models/swin_unetr.py``, the window attention's
plain version on the CPU) against the benchmark's plain reference
(``portbench/reference/swin_unetr.py``), at feature size 12 with seeded
weights; its checkpoints through ``load_unet``; the chunk grid and the
microbatch that the U-Net keeps; one ``affinity_unet_watershed`` call
against the reference's labels; and planted faults that the comparison
catches.

The sizes: (32, 64, 64) reaches a padded, shifted stage 0 (16 x 32 x 32,
padded to 21 x 35 x 35) and a clipped, unshifted stage 3 (2 x 4 x 4);
(64, 32, 96) has unequal axes, and its stage 2 (8 x 4 x 12) shifts two
axes and clips the third. A (32, 32, 32) input would leave the bottleneck
one voxel, where InstanceNorm is undefined (MONAI raises there too).
"""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench"))

from harness import compare, frames  # noqa: E402
from reference import swin_unetr as ref  # noqa: E402

from iterseg_tpu_torch.engine import device_pipeline as tdp  # noqa: E402
from iterseg_tpu_torch.engine.predict import (UNetModel,  # noqa: E402
                                              _pick_batch_size, load_unet)
from iterseg_tpu_torch.models import swin_unetr as swin  # noqa: E402
from iterseg_tpu_torch.models.convert import params_to_numpy  # noqa: E402
from iterseg_tpu_torch.models.unet import UNet, UNetSpec  # noqa: E402
from iterseg_tpu_torch.ops import window_attention as wa  # noqa: E402

CPU = torch.device("cpu")
FEATURES = 12
SHAPES = [(32, 64, 64), (64, 32, 96)]
# On the CPU the program runs the reference's operations in its order, so
# the gap reads 0. 1e-5 leaves room for a reduction taken in another order
# (float32 sums of O(1) terms after LayerNorm, outputs in (0, 1)). Each
# planted fault below moves the outputs by more than 1e-4: the bias index
# least (2.7e-4; the bias table's std is 0.02).
TOL = 1e-5


@pytest.fixture(scope="module")
def net():
    return swin.SwinUNETR(swin.SwinUNETRSpec(1, 5, FEATURES)).init_weights(7)


def _input(shape, seed=0):
    return torch.rand((1, 1) + shape, generator=torch.Generator().manual_seed(
        seed))


def _gap(net, x):
    with torch.no_grad():
        return float((net(x) - ref.forward(net.state_dict(), x)).abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_the_reference(net, shape):
    assert _gap(net, _input(shape)) <= TOL


def test_init_draws_the_references_weights(net):
    want = ref.init_params(7, feature_size=FEATURES)
    got = net.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    assert sum(p.numel() for p in net.parameters()) == ref.widths(want)[
        "learnt_parameters"] == 4_078_103


def test_the_published_widths_count_monais_parameters():
    """feature size 48: 62,186,855 learnt at 5 outputs, MONAI's 62.19 M
    (62,187,296) at BTCV's 14."""
    for out, count in ((5, 62_186_855), (14, 62_187_296)):
        shapes = ref.names(out_channels=out)
        assert sum(int(np.prod(s)) for k, s in shapes.items()
                   if not k.endswith("index")) == count
    assert set(swin.SwinUNETR().state_dict()) == set(ref.names())


@pytest.mark.parametrize("fault", ["mask_sign", "bias_index",
                                   "merge_order"])
def test_a_planted_fault_is_caught(net, fault, monkeypatch):
    if fault == "mask_sign":
        monkeypatch.setattr(wa, "MASK_VALUE", -wa.MASK_VALUE)
    elif fault == "bias_index":
        real = wa.relative_index
        monkeypatch.setattr(wa, "relative_index",
                            lambda n, *a, **kw: real(n, *a, **kw).T)
    else:
        monkeypatch.setattr(swin.PatchMerging, "ORDER", tuple(
            itertools.product(range(2), repeat=3)))
    assert _gap(net, _input(SHAPES[0])) > 10 * TOL


def test_a_monai_state_dict_round_trips_through_load_unet(net, tmp_path):
    path = str(tmp_path / "swin.pt")
    torch.save(net.state_dict(), path)
    model = load_unet(path)
    assert model.spec == net.spec and model.out_channels == 5
    assert model.chunk_multiples == (32, 32, 32)
    got, saved = model.module(CPU).state_dict(), torch.load(path)
    assert list(got) == list(saved)
    for k in saved:
        assert torch.equal(got[k], saved[k]), k
    x = _input(SHAPES[0], seed=1)
    np.testing.assert_array_equal(model(x.numpy(), device=CPU).numpy(),
                                  net(x).detach().numpy())
    missing = dict(saved)
    del missing["out.conv.conv.bias"]
    torch.save(missing, path)
    with pytest.raises(RuntimeError, match="out.conv.conv.bias"):
        load_unet(path).module(CPU)
    foreign = dict(saved)
    key = "swinViT.layers2.0.blocks.1.attn.relative_position_index"
    foreign[key] = saved[key].T.contiguous()
    torch.save(foreign, path)
    with pytest.raises(ValueError, match="relative index"):
        load_unet(path).module(CPU)


def test_the_unet_keeps_its_grid_and_microbatch(monkeypatch):
    """The U-Net's chunk multiples and activation bytes give the values
    the grid and the microbatch had before the model said them; the Swin
    UNETR's give the cell's grid and microbatch 7 on an 80 GB card."""
    unet = UNetModel(params_to_numpy(UNet(UNetSpec(1, 5))))
    assert unet.chunk_multiples == (2, 16, 16)
    assert unet.activation_bytes((10, 256, 256)) == 10 * 256 * 256 * 512
    grid = ((10, 256, 256), (1, 64, 64))
    for zyx, want in (
            ((33, 512, 512), ([(0, 0)] * 3, (33, 512, 512), (10, 256, 256),
                              (1, 64, 64))),
            ((5, 20, 300), ([(0, 0)] * 3, (5, 20, 300), (4, 16, 256),
                            (1, 7, 64))),
            ((1, 8, 8), ([(0, 1), (0, 8), (0, 8)], (2, 16, 16), (2, 16, 16),
                         (0, 7, 7)))):
        assert tdp._valid_grid(zyx, *grid) == want
        assert tdp._valid_grid(zyx, *grid, unet.chunk_multiples) == want
    for n, want in ((1, 1), (7, 7), (36, 6), (49, 7), (100, 8)):
        assert _pick_batch_size(n, grid[0], 5, CPU) == want
        assert _pick_batch_size(n, grid[0], 5, CPU, unet.activation_bytes(
            grid[0])) == want
    spec = swin.SwinUNETRSpec()
    assert tdp._valid_grid((96, 512, 512), (96, 96, 96), (12, 12, 12),
                           spec.chunk_multiples)[2:] == ((96, 96, 96),
                                                         (12, 12, 12))
    monkeypatch.setattr("iterseg_tpu_torch.engine.predict._memory_budget",
                        lambda device: (80 << 30) // 4)
    assert _pick_batch_size(49, (96, 96, 96), 5, None, spec.activation_bytes(
        (96, 96, 96))) == 7


def test_affinity_unet_watershed_matches_the_reference(net, tmp_path):
    """A 2-frame stack round-robined over a ``devices`` list of two (the
    CPU twice), as the stack driver runs it on two cards."""
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed

    path = str(tmp_path / "swin.pt")
    torch.save(net.state_dict(), path)
    pool = frames.frame_pool(11, 2, (32, 64, 96), 20, 50000, 500, CPU,
                             "uint16")
    kw = {"chunk_size": (32, 64, 64), "margin": (4, 8, 8)}
    got = affinity_unet_watershed(None, np.stack(pool), None, "swin", path,
                                  devices=[CPU, CPU], debug=True, **kw)
    params = ref.load_params(path, CPU)
    for frame, labels in zip(pool, got):
        want = ref.affinity_labels(frame, params, kw["chunk_size"],
                                   kw["margin"], CPU)
        assert want.max() > 0
        assert compare.label_mismatch(np.asarray(labels), want) == 0.0


def test_training_and_the_mesh_refuse_a_swin_checkpoint(net, tmp_path):
    from iterseg_tpu_torch.parallel import mesh
    from iterseg_tpu_torch.train.train import train_unet

    path = str(tmp_path / "swin.pt")
    torch.save(net.state_dict(), path)
    x = [np.zeros((4, 16, 16), np.float32)]
    y = [np.zeros((5, 4, 16, 16), np.float32)]
    with pytest.raises(ValueError, match="Swin UNETR"):
        train_unet(x, x, y, y, weights=path, device=CPU)
    cpus = mesh.make_mesh(devices=[CPU])
    with pytest.raises(ValueError, match="Swin UNETR"):
        mesh.sharded_predict_volume(load_unet(path), np.zeros(
            (32, 64, 64), np.float32), cpus)
    with pytest.raises(ValueError, match="Swin UNETR"):
        mesh.make_sharded_train_step(cpus, net, None, None)
