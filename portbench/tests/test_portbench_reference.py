"""The plain reference equals the program on the CPU at a tiny size: the
U-Net's features, both segmenters' labels, the first train steps."""
import os

import numpy as np
import pytest
import torch

from conftest import PORTBENCH, tiny

CKPT = os.path.join(os.path.dirname(PORTBENCH), "iterseg_tpu", "data",
                    "default_unet.npz")
CPU = torch.device("cpu")


def test_unet_forward_matches_the_program():
    from iterseg_tpu_torch.engine.predict import load_unet
    from reference import unet

    x = torch.rand((2, 1, 10, 64, 64), generator=torch.Generator()
                   .manual_seed(0))
    want = load_unet(CKPT).module(CPU)
    with torch.no_grad():
        got = unet.forward(unet.load_params(CKPT, CPU), x)
        np.testing.assert_allclose(got.numpy(), want(x).numpy(),
                                   rtol=0, atol=2e-6)


def test_unet_train_forward_matches_the_program():
    from iterseg_tpu_torch.engine.predict import load_unet
    from reference import unet

    x = torch.rand((1, 1, 10, 32, 64), generator=torch.Generator()
                   .manual_seed(1))
    net = load_unet(CKPT).module(CPU).train()
    with torch.no_grad():
        got = unet.forward(unet.load_params(CKPT, CPU), x, train=True)
        np.testing.assert_allclose(got.numpy(), net(x).numpy(), rtol=0,
                                   atol=2e-5)


def test_chunk_grid_matches_the_program():
    from iterseg_tpu_torch.core.chunks import make_chunks
    from reference.unet import chunk_grid

    for shape, chunk, margin in [((33, 512, 512), (10, 256, 256),
                                  (1, 64, 64)),
                                 ((12, 96, 200), (10, 64, 64), (1, 16, 16))]:
        starts, crops = make_chunks(shape, chunk, margin)
        grid = chunk_grid(shape, chunk, margin)
        assert [tuple(s) for s in starts] == [g[0] for g in grid]
        assert [tuple(map(tuple, c)) for c in crops] == [g[1] for g in grid]
    assert len(chunk_grid((33, 512, 512), (10, 256, 256), (1, 64, 64))) == 36


@pytest.mark.parametrize("cell", ["unet.stack", "dog.volume"])
def test_segmenter_labels_match_the_program(cell):
    from harness import frames
    from iterseg_tpu_torch.engine import segmentation as seg
    from reference import segment, unet

    _, cfg, _, _ = tiny(cell, frame=(12, 64, 96))
    vol = frames.frame_pool(7, 1, cfg["frame"], 16, 50000, 500, CPU)[0]
    s = cfg["segment"]
    if cell == "unet.stack":
        got = seg.affinity_unet_watershed(
            None, vol, None, "t", CKPT, chunk_size=tuple(s["chunk"]),
            margin=tuple(s["margin"]), devices=[CPU])
        want = segment.affinity_labels(vol, unet.load_params(CKPT, CPU),
                                       s["chunk"], s["margin"], CPU)
    else:
        got = seg.dog_blob_watershed(None, vol, None, "t", devices=[CPU])
        want = segment.dog_labels(vol, s, CPU)
    assert want.max() >= 3  # objects were found
    np.testing.assert_array_equal(got, want)


def test_train_steps_match_the_program(cpu_context):
    from drivers.train import _norms
    from harness import bench

    ctx, _ = cpu_context("unet.train")
    d = bench.make_driver(ctx)
    d.warm()
    d.window(0.1)
    losses, grads, change = d._reference()
    prog = d.program()
    np.testing.assert_allclose(prog[0], losses, rtol=1e-6)
    kept = d.kept()
    # the leaves left out are the conv biases right before a BatchNorm
    assert sorted(d.left_out) == sorted(
        k for k in grads if k.endswith(".bias") and ".conv" in k)
    assert max(d.left_out.values()) < 1e-6
    med = np.median([grads[k] for k in kept])
    for k in kept:
        assert abs(prog[1][k] - grads[k]) <= 1e-4 * max(grads[k], med), k
    gaps = d._gaps(prog, (losses, grads, change))
    assert gaps["change_gap"] < 0.05
    assert set(_norms(d.state["grad"])) == set(grads)
