"""Tests of the port that need a CUDA card: the hand-written kernels (the
affinity and the image flood) have no CPU mode, training is held on the
card against the CPU, and the CLI and the server drive the CUDA flood.
Every test carries the ``cuda`` marker and skips without a card.
This file imports neither JAX nor ``iterseg_tpu``, so it also runs on a GPU
machine that has only torch:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import os

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi
from slab_uploads import slab_by_slab

from iterseg_tpu_torch.ops import flood_kernel as fk
from iterseg_tpu_torch.ops import image_flood_kernel as ifk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def noise_case(shape=(12, 20, 20), n_seeds=6, seed=0):
    """White-noise affinities, a full interior mask, random seeds."""
    r = np.random.default_rng(seed)
    aff = r.random((3,) + shape).astype(np.float32)
    mask = np.pad(np.ones([s - 2 for s in shape], bool), 1)
    coords = np.unique(np.stack(
        [r.integers(2, s - 2, size=n_seeds) for s in shape], axis=1), axis=0)
    return aff, coords, mask


def smooth_case(shape=(16, 40, 40), n=20, seed=0):
    """Smooth affinities with ridges at object boundaries, seeds at peaks."""
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(3, s - 3, size=n) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1.5, 3, 3))
    vol /= vol.max()
    aff = np.stack([1.0 - vol] * 3).astype(np.float32)
    mask = np.pad(vol[1:-1, 1:-1, 1:-1] > 0.08, 1)
    seeds = np.argwhere((vol == ndi.maximum_filter(vol, size=5)) & mask)
    return aff, seeds, mask


def as_inputs(aff, coords, mask, device):
    seeds = np.zeros(mask.shape, np.int32)
    seeds[tuple(coords.T)] = np.arange(1, len(coords) + 1, dtype=np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (aff, seeds, mask))


@pytest.mark.parametrize("inner_cap", [1, 4])
@pytest.mark.parametrize("case", [noise_case, smooth_case])
def test_kernel_equals_plain(cuda, case, inner_cap):
    inputs = as_inputs(*case(), device=cuda)
    before = fk.launches()
    stats, plain_stats = {}, {}
    got, n, conv = fk.affinity_flood(*inputs, inner_cap=inner_cap,
                                     stats=stats)
    want, n_plain, conv_plain = fk.affinity_flood_plain(
        *inputs, inner_cap=inner_cap, stats=plain_stats)
    torch.cuda.synchronize()
    assert fk.launches() == before + 2  # the init and the one step kernel
    assert conv and conv_plain and n == n_plain == stats["steps"]
    assert torch.equal(got, want)
    assert stats["tile_steps"] == plain_stats["tile_steps"]
    assert plain_stats["missed"] == 0


def test_kernel_ragged_shape_and_non_convergence(cuda):
    # a shape that is no multiple of the tile on any axis, and step caps
    # before, at and after the converging step
    inputs = as_inputs(*smooth_case(shape=(13, 37, 45), seed=2), device=cuda)
    got, n, conv = fk.affinity_flood(*inputs)
    want, n_plain, _ = fk.affinity_flood_plain(*inputs)
    assert conv and n == n_plain and torch.equal(got, want)
    for cap in (1, 2, n - 1, n):
        stats, plain_stats = {}, {}
        part, n2, conv2 = fk.affinity_flood(*inputs, max_launches=cap,
                                            stats=stats)
        plain2, n2_plain, conv2_plain = fk.affinity_flood_plain(
            *inputs, max_launches=cap, stats=plain_stats)
        assert n2 == n2_plain == cap and conv2 == conv2_plain == (cap == n)
        assert torch.equal(part, plain2)
        assert stats["tile_steps"] == plain_stats["tile_steps"]


def test_fast_path_equals_generic_on_card(cuda):
    from iterseg_tpu_torch.engine.device_pipeline import AffinityPipeline
    from iterseg_tpu_torch.engine.predict import load_unet, predict_volume
    from iterseg_tpu_torch.ops.watershed import segment_output_image

    r = np.random.default_rng(0)
    vol = np.zeros((10, 96, 96), np.float32)
    pts = np.stack([r.integers(1, s - 1, size=30) for s in vol.shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 3, 3))
    vol /= vol.max()
    model = load_unet(None)
    chunk, margin = (10, 64, 64), (1, 16, 16)
    fast = AffinityPipeline(model, chunk, margin).segment(vol)
    feats = predict_volume(model, vol, chunk, margin)
    generic, _, _ = segment_output_image(feats, (0, 1, 2), 4, 3)
    np.testing.assert_array_equal(fast, generic)
    pallas = AffinityPipeline(model, chunk, margin,
                              device_flood="pallas").segment(vol)
    np.testing.assert_array_equal(pallas > 0, fast > 0)
    assert set(np.unique(pallas)) == set(np.unique(fast))


def edt_case(shape=(16, 48, 48), n=25, seed=0):
    """The DoG path's flood landscape: blobs -> mask, values = -EDT,
    labelled markers at the distance peaks."""
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(3, s - 3, size=n) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1.0, 2.0, 2.0))
    vol /= vol.max()
    mask = vol > 0.15
    dist = ndi.distance_transform_edt(mask)
    peaks = np.argwhere((dist == ndi.maximum_filter(dist, size=3)) & mask)
    markers = np.zeros(shape, np.int32)
    markers[tuple(peaks.T)] = 1
    markers, _ = ndi.label(markers)
    return (-dist).astype(np.float32), markers.astype(np.int32), mask


@pytest.mark.parametrize("inner_cap", [1, 4])
@pytest.mark.parametrize("shape", [(16, 48, 48), (13, 37, 45)])
def test_image_kernel_equals_plain(cuda, shape, inner_cap):
    inputs = tuple(torch.from_numpy(x).to(cuda)
                   for x in edt_case(shape=shape, seed=len(shape) + shape[1]))
    before = ifk.launches()
    stats, plain_stats = {}, {}
    got, n, conv = ifk.image_flood(*inputs, inner_cap=inner_cap, stats=stats)
    want, n_plain, conv_plain = ifk.image_flood_plain(
        *inputs, inner_cap=inner_cap, stats=plain_stats)
    torch.cuda.synchronize()
    assert ifk.launches() == before + 2  # the init and the one step kernel
    assert conv and conv_plain and n == n_plain == stats["steps"]
    assert torch.equal(got, want)
    assert stats["tile_steps"] == plain_stats["tile_steps"]
    part, n2, conv2 = ifk.image_flood(*inputs, max_launches=2,
                                      inner_cap=inner_cap)
    plain2, _, _ = ifk.image_flood_plain(*inputs, max_launches=2,
                                         inner_cap=inner_cap)
    assert n2 == 2 and not conv2 and torch.equal(part, plain2)


@pytest.mark.parametrize("flood", ["affinity", "image"])
def test_init_kernel_equals_init_state(cuda, flood):
    """The init kernel writes init_state / image_init_state into both
    buffers (the halo words everywhere, the claimant key where a step reads
    it: at free voxels), the code, and list 1: every tile that holds a free
    voxel."""
    from iterseg_tpu_torch.ops.device_flood import (image_init_state,
                                                    init_state)
    from iterseg_tpu_torch.ops.flood_kernel import TileGrid

    values, seeds, mask = (torch.from_numpy(x).to(cuda)
                           for x in edt_case(shape=(13, 37, 45), seed=4))
    seeds[0, 0, 0] = -3  # a negative seed outside the mask stays unlabelled
    if flood == "affinity":
        aff = torch.stack([values] * 3).contiguous()
        state, code, first = fk.affinity_flood_start(aff, seeds, mask)
        d, lab, ckd, cki, want_code = init_state(seeds, mask)
        want, halo_words = (d, lab, ckd, cki), 2
    else:
        state, code, first = ifk.image_flood_start(values, seeds, mask)
        *want, want_code = image_init_state(values, seeds, mask)
        halo_words = 3
    assert torch.equal(code, want_code)
    free = want_code == 1
    for buf in range(2):
        for w, x in enumerate(want):
            got = state[buf, w]
            if x.dtype == torch.float32:
                got = got.view(torch.float32)
            if w >= halo_words:
                got, x = got[free], x[free]
            assert torch.equal(got, x), (buf, w)
    grid = TileGrid(mask.shape, fk.TILE)
    holds = grid.tiled(want_code == 1, False).flatten(3).any(-1).flatten()
    assert torch.equal(first.long().cpu(),
                       holds.nonzero().flatten().cpu())


def test_dog_fast_path_and_pallas_on_card(cuda):
    from iterseg_tpu_torch.engine.device_pipeline import DoGPipeline
    from iterseg_tpu_torch.engine.segmentation import (
        dog_blob_watershed_for_chunks)

    r = np.random.default_rng(3)
    vol = np.zeros((12, 48, 48), np.float32)
    pts = np.stack([r.integers(3, s - 3, size=16) for s in vol.shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 2, 2))
    vol /= vol.max()
    fast = DoGPipeline().segment(vol)
    host = np.zeros(fast.shape, np.int32)
    dog_blob_watershed_for_chunks(vol, host, None, None, 1, 1.5, 0.02,
                                  use_device_pipeline=False)
    np.testing.assert_array_equal(fast, host)
    np.testing.assert_array_equal(
        fast, DoGPipeline(device=torch.device("cpu")).segment(vol))
    before = ifk.launches()
    pallas = DoGPipeline(device_flood="pallas").segment(vol)
    assert ifk.launches() > before
    np.testing.assert_array_equal(pallas > 0, fast > 0)
    assert set(np.unique(pallas)) == set(np.unique(fast))


def train_step_on(net, x, y, device):
    """One train-mode forward and backward of ``net`` on ``device``: the
    BCE loss, the gradients and the new running stats, on the CPU."""
    from iterseg_tpu_torch.device import f32_numerics
    from iterseg_tpu_torch.train.losses import bce_loss

    net = net.to(device).train()
    with f32_numerics():
        loss = bce_loss(net(torch.from_numpy(x).to(device)),
                        torch.from_numpy(y).to(device))
        loss.backward()
    grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
    stats = {k: v.cpu() for k, v in net.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(loss.detach()), grads, stats


def test_train_step_on_card_matches_cpu(cuda):
    """The ``train_parity`` bounds of chip_smoke.py: loss within 1e-5
    relative, every gradient within 5e-3 x the largest gradient, running
    stats within 1e-5 of each statistic's largest magnitude."""
    from iterseg_tpu_torch.engine.predict import load_unet
    from iterseg_tpu_torch.models.convert import params_from_numpy
    from iterseg_tpu_torch.train.labels import get_training_labels

    r = np.random.default_rng(6)
    vol = np.zeros((10, 64, 64), np.float32)
    pts = np.stack([r.integers(1, s - 1, size=30) for s in vol.shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 3, 3))
    vol /= vol.max()
    gt = ndi.label(vol > 0.25)[0]
    x = vol[None, None]
    y = get_training_labels(gt, ("z-1", "y-1", "x-1", "mask",
                                 "centreness-log"), (4, 1, 1),
                            device=cuda).astype(np.float32)[None]
    params = load_unet(None).params
    card = train_step_on(params_from_numpy(params), x, y, cuda)
    host = train_step_on(params_from_numpy(params), x, y,
                         torch.device("cpu"))
    assert abs(card[0] - host[0]) <= 1e-5 * abs(host[0])
    gmax = max(float(g.abs().max()) for g in host[1].values())
    for k, g in host[1].items():
        assert float((card[1][k] - g).abs().max()) <= 5e-3 * gmax, k
    for k, v in host[2].items():
        assert float((card[2][k] - v).abs().max()) <= 1e-5 * float(
            v.abs().max()), k


def test_train_unet_on_card_writes_a_checkpoint(cuda, tmp_path):
    from iterseg_tpu_torch.engine.predict import load_unet
    from iterseg_tpu_torch.train.train import train_unet

    r = np.random.default_rng(1)
    xs = [r.random((4, 32, 32), dtype=np.float32) for _ in range(3)]
    ys = [(r.random((5, 4, 32, 32)) > 0.5).astype(np.float32)
          for _ in range(3)]
    model, path = train_unet(xs[:2], xs[2:], ys[:2], ys[2:],
                             out_dir=str(tmp_path), name="card", epochs=2)
    assert path is not None and os.path.exists(path)
    with np.load(path) as z:
        assert not any(k.endswith("num_batches_tracked") for k in z.files)
    out = load_unet(path)(np.zeros((1, 1, 4, 32, 32), np.float32))
    assert out.device.type == "cuda" and out.shape == (1, 5, 4, 32, 32)
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(
        out.cpu().numpy(),
        model(np.zeros((1, 1, 4, 32, 32), np.float32)).cpu().numpy())


def blob_zarr(path, shape, seed):
    """A seeded blob volume saved as a float32 zarr store; returns it."""
    from iterseg_tpu_torch.io.zarr_io import open_zarr

    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(1, s - 1, size=30) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 3, 3))
    vol /= vol.max()
    arr = open_zarr(str(path), shape=shape, chunks=shape, dtype=np.float32)
    arr[...] = vol
    return vol


def test_cli_segment_pallas_on_card(cuda, tmp_path):
    """``segment --device-flood pallas`` through the CLI: one flood, two
    kernel launches, labels equal to the direct segmenter call."""
    from iterseg_tpu_torch.cli import main
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed
    from iterseg_tpu_torch.io.zarr_io import open_zarr

    vol = blob_zarr(tmp_path / "vol.zarr", (10, 96, 96), 0)
    fk.reset_launches()
    assert main(["segment", "--input", str(tmp_path / "vol.zarr"),
                 "--output-dir", str(tmp_path), "--name", "cli",
                 "--chunk-size", "10,64,64", "--margin", "1,16,16",
                 "--device-flood", "pallas"]) == 0
    assert fk.launches() == 2
    got = np.asarray(open_zarr(str(tmp_path / "cli.ome.zarr" / "0")))
    want = affinity_unet_watershed(None, vol, None, "x", None,
                                   chunk_size=(10, 64, 64),
                                   margin=(1, 16, 16), debug=True,
                                   device_flood="pallas")
    assert got.max() > 0
    np.testing.assert_array_equal(got, want)


def test_serve_once_pallas_on_card(cuda, tmp_path):
    """``serve --once`` over two volumes with a ``"pallas"`` config: no
    error, two launches of the affinity kernel per frame."""
    import json

    from iterseg_tpu_torch.cli import main

    w = tmp_path / "in"
    w.mkdir()
    blob_zarr(w / "a.zarr", (10, 96, 96), 1)
    blob_zarr(w / "b.zarr", (10, 64, 64), 2)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"unet": "default", "device_flood": "pallas"}))
    fk.reset_launches()
    assert main(["serve", "--watch-dir", str(w), "--output-dir",
                 str(tmp_path / "out"), "--network", str(cfg),
                 "--chunk-size", "10,64,64", "--margin", "1,16,16",
                 "--once"]) == 0
    assert fk.launches() == 2 * 2
    assert sorted(os.listdir(tmp_path / "out")) == [
        "a.done", "a.ome.zarr", "b.done", "b.ome.zarr"]


def prod_like_outs(seed, device, shape=(16, 40, 40), n=16):
    """The affinity pipeline's device outputs for a prod-like volume: three
    distinct smooth affinity channels, the mask above 0.08, candidates at
    the 5³ peaks (``tests/test_flood_exact`` builds the same with JAX)."""
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(3, s - 3, size=n) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1.5, 3, 3))
    vol /= vol.max()
    aff = np.stack([ndi.gaussian_filter(
        1.0 - vol + r.normal(0, 0.01, shape).astype(np.float32), 0.5)
        for _ in range(3)]).astype(np.float32)
    mask = vol > 0.08
    peaks = np.argwhere((vol == ndi.maximum_filter(vol, size=5)) & mask)
    order = np.zeros(256, np.int64)
    flat = np.ravel_multi_index(tuple(peaks.T), shape)
    order[:len(flat)] = flat
    outs = (np.pad(aff, ((0, 0),) + ((1, 1),) * 3),
            np.packbits(mask.ravel()), order, np.int32(len(flat)),
            np.float32(0.08), vol)
    return shape, tuple(torch.as_tensor(o).to(device) for o in outs)


@pytest.mark.parametrize("case", [noise_case, smooth_case])
def test_certificate_on_card_equals_cpu(cuda, case):
    from iterseg_tpu_torch.ops.flood_exact import (certificate_flood,
                                                   image_certificate_flood)

    aff, coords, mask = case()
    want = certificate_flood(aff, coords, mask, device="cpu")
    got = certificate_flood(aff, coords, mask, device=cuda)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]
    image, markers, imask = edt_case()
    want = image_certificate_flood(image, markers, imask, device="cpu")
    got = image_certificate_flood(image, markers, imask, device=cuda)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


def test_exact_floods_on_card_equal_cpu(cuda):
    from iterseg_tpu_torch.ops import flood_exact as fe
    from iterseg_tpu_torch.ops.watershed import (affinity_watershed,
                                                 image_watershed)

    for case in (noise_case, smooth_case):
        aff, coords, mask = case()
        host = affinity_watershed(aff, coords, mask)
        for guards in ((fe.TIE_PROBE_DEFAULT, fe.REPAIR_DOOM_FRAC),
                       (0.0, 0.0)):
            tc, tg = {}, {}
            want = fe.exact_affinity_flood(aff, coords, mask, telemetry=tc,
                                           tie_probe=guards[0],
                                           repair_doom=guards[1],
                                           device="cpu")
            got = fe.exact_affinity_flood(aff, coords, mask, telemetry=tg,
                                          tie_probe=guards[0],
                                          repair_doom=guards[1], device=cuda)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, host)
            assert tg == tc
        inputs = as_inputs(aff, coords, mask, cuda)
        got = fe.verified_exact_flood(*inputs, tie_probe=0.0, repair_doom=0.0)
        want = fe.verified_exact_flood(*(t.cpu() for t in inputs),
                                       tie_probe=0.0, repair_doom=0.0)
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
        assert got[1:] == want[1:]
    image, markers, imask = edt_case()
    got = fe.exact_image_flood(image, markers, imask, tie_probe=0.0,
                               repair_doom=0.0, device=cuda)
    np.testing.assert_array_equal(got, image_watershed(image, markers, imask))


@pytest.mark.parametrize("mode", ["claim", "minimax"])
def test_xla_floods_on_card_equal_cpu(cuda, mode):
    from iterseg_tpu_torch.ops import device_flood as df

    for case in (noise_case, smooth_case):
        aff, coords, mask = case()
        for loop in ((512, 8), (10, 8)):
            want = df.wavefront_affinity_flood(aff, coords, mask, mode, *loop,
                                               device="cpu")
            got = df.wavefront_affinity_flood(aff, coords, mask, mode, *loop,
                                              device=cuda)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
    image, markers, imask = edt_case()
    want = df.wavefront_image_flood(image, markers, imask, mode, device="cpu")
    got = df.wavefront_image_flood(image, markers, imask, mode, device=cuda)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("seed", [5, 8, 0])
def test_pipeline_modes_on_card_equal_cpu(cuda, seed):
    """Given the same device outputs, ``"exact"`` on the card is the
    default flood's labels (certified, repaired, unresolved with the
    speculative host flood), and ``"xla"`` with telemetry is the CPU's run
    with the same counts."""
    from iterseg_tpu_torch.engine.device_pipeline import AffinityPipeline

    cpu = torch.device("cpu")
    shape, outs = prod_like_outs(seed, cuda)
    shape, outs_cpu = prod_like_outs(seed, cpu)
    want = AffinityPipeline(None, cand_capacity=256, device=cpu)._finalize(
        shape, outs_cpu).copy()
    prof = {}
    got = AffinityPipeline(None, cand_capacity=256, device_flood="exact",
                           device=cuda)._finalize(shape, outs, profile=prof)
    np.testing.assert_array_equal(got, want)
    assert prof["flood_exact_path"] == {
        5: "certified", 8: "repaired", 0: "fallback:unresolved"}[seed]
    pc, pg = {}, {}
    kw = dict(cand_capacity=256, device_flood="xla", flood_telemetry=True)
    want = AffinityPipeline(None, device=cpu, **kw)._finalize(
        shape, outs_cpu, profile=pc)
    got = AffinityPipeline(None, device=cuda, **kw)._finalize(
        shape, outs, profile=pg)
    np.testing.assert_array_equal(got, want)
    for key in ("flood_iters", "flood_uncertain_frac",
                "flood_disagreement_bound", "flood_mask_voxels",
                "flood_certificate_converged"):
        assert pg[key] == pc[key], key


def test_dog_modes_on_card(cuda):
    from iterseg_tpu_torch.engine.device_pipeline import DoGPipeline

    r = np.random.default_rng(3)
    vol = np.zeros((12, 48, 48), np.float32)
    pts = np.stack([r.integers(3, s - 3, size=16) for s in vol.shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 2, 2))
    vol /= vol.max()
    fast = DoGPipeline().segment(vol)
    np.testing.assert_array_equal(DoGPipeline(device_flood="exact").segment(
        vol), fast)
    np.testing.assert_array_equal(
        DoGPipeline(device_flood="xla").segment(vol),
        DoGPipeline(device_flood="xla", device=torch.device("cpu")).segment(
            vol))


def test_true_resolves_to_pallas_or_host_on_card(cuda):
    from iterseg_tpu_torch.engine import linkprobe
    from iterseg_tpu_torch.engine.device_pipeline import (AffinityPipeline,
                                                          DoGPipeline)

    linkprobe.reset_cache()
    mbps = linkprobe.measure_link_mbps()
    assert mbps is not None and mbps > 0
    want = ("pallas" if mbps >= linkprobe.MEASURED[
        "device_flood_crossover_mbps"] else False)
    for cls in (AffinityPipeline, DoGPipeline):
        assert cls.normalize_device_flood(True) == want
        assert cls.normalize_device_flood(True, cuda) == want
    assert DoGPipeline(device_flood=True).device_flood == want


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("flood", ["affinity", "image"])
def test_kernels_launch_on_the_second_card(two_cards, flood):
    """A flood on cuda:1 tensors, with cuda:0 current, runs on cuda:1 and
    equals its plain version; the current card is left as it was."""
    dev = two_cards[1]
    if flood == "affinity":
        inputs = as_inputs(*smooth_case(seed=3), device=dev)
        kernel, plain, count = (fk.affinity_flood, fk.affinity_flood_plain,
                                fk.launches)
    else:
        inputs = tuple(torch.from_numpy(x).to(dev) for x in edt_case(seed=3))
        kernel, plain, count = (ifk.image_flood, ifk.image_flood_plain,
                                ifk.launches)
    torch.cuda.set_device(two_cards[0])
    before = count()
    got, n, conv = kernel(*inputs)
    want, n_plain, _ = plain(*inputs)
    assert count() == before + 2 and torch.cuda.current_device() == 0
    assert got.device == dev and conv and n == n_plain
    assert torch.equal(got, want)


def stack_case(n_frames=3, shape=(10, 96, 96)):
    r = np.random.default_rng(11)
    frames = []
    for _ in range(n_frames):
        vol = np.zeros(shape, np.float32)
        pts = np.stack([r.integers(1, s - 1, size=30) for s in shape], 1)
        vol[tuple(pts.T)] = 1.0
        vol = ndi.gaussian_filter(vol, (1, 3, 3))
        frames.append((vol / vol.max() * 60000).astype(np.uint16))
    return np.stack(frames)


def round_robin(kind, devices, stack):
    from iterseg_tpu_torch.engine import device_pipeline as dp
    from iterseg_tpu_torch.engine.predict import load_unet

    if kind == "affinity":
        pipe = dp.AffinityPipeline(load_unet(None), (10, 64, 64),
                                   (1, 16, 16), device_flood="pallas",
                                   device=devices[0])
        launches, reset = fk.launches, fk.reset_launches
    else:
        pipe = dp.DoGPipeline(device_flood="pallas", device=devices[0])
        launches, reset = ifk.launches, ifk.reset_launches
    out = np.zeros(stack.shape, np.int32)
    reset()
    dp.reset_flood_fallbacks()
    assert list(pipe.segment_stack(stack, out, devices=devices)) == list(
        range(len(stack)))
    assert launches() == 2 * len(stack) and dp.flood_fallbacks() == 0
    return out


@pytest.mark.parametrize("kind", ["affinity", "dog"])
def test_one_card_listed_twice_equals_one_card(cuda, kind):
    """The round-robin and its lookahead on one card: ``[cuda, cuda]``
    gives ``[cuda]``'s labels, two flood launches a frame."""
    stack = stack_case()
    one = round_robin(kind, [cuda], stack)
    assert one.max() > 0
    np.testing.assert_array_equal(round_robin(kind, [cuda, cuda], stack), one)


@pytest.mark.parametrize("kind", ["affinity", "dog"])
def test_two_card_round_robin_equals_one_card(two_cards, kind):
    stack = stack_case()
    one = round_robin(kind, two_cards[:1], stack)
    np.testing.assert_array_equal(round_robin(kind, two_cards, stack), one)


def test_dp_train_step_on_cards_matches_cpu(cuda):
    """The data-parallel step over ``[cuda, cuda]`` (two cards when there
    are two) against ``[cpu, cpu]``, with ``train_parity``'s bounds."""
    from iterseg_tpu_torch.engine.predict import load_unet
    from iterseg_tpu_torch.models.convert import params_from_numpy
    from iterseg_tpu_torch.parallel.mesh import Mesh, make_sharded_train_step
    from iterseg_tpu_torch.train.losses import make_loss_function

    r = np.random.default_rng(2)
    x = r.random((2, 1, 10, 64, 64)).astype(np.float32)
    y = (r.random((2, 5, 10, 64, 64)) > 0.5).astype(np.float32)
    cards = [torch.device("cuda", i % torch.cuda.device_count())
             for i in range(2)]
    params = load_unet(None).params
    got = {}
    for name, devices in (("card", cards), ("cpu", [torch.device("cpu")] * 2)):
        net = params_from_numpy(params).to(devices[0]).train()
        step = make_sharded_train_step(
            Mesh([[d] for d in devices]), net, make_loss_function("BCELoss"),
            torch.optim.SGD(net.parameters(), lr=0.0), double_step=False)
        loss = float(step(x, y, 0))
        got[name] = (loss, {k: p.grad.cpu() for k, p in
                            net.named_parameters()},
                     {k: v.cpu() for k, v in net.state_dict().items()
                      if "running" in k})
    card, host = got["card"], got["cpu"]
    assert abs(card[0] - host[0]) <= 1e-5 * abs(host[0])
    gmax = max(float(g.abs().max()) for g in host[1].values())
    for k, g in host[1].items():
        assert float((card[1][k] - g).abs().max()) <= 5e-3 * gmax, k
    for k, v in host[2].items():
        assert float((card[2][k] - v).abs().max()) <= 1e-5 * float(
            v.abs().max()), k


def platelet_frame(seed, shape=(33, 512, 512)):
    """A uint16 frame at the benchmark's size: 900 blurred blobs, peak
    50,000, noise below 500."""
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(1, s - 1, size=900) for s in vol.shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 4, 4))
    return (vol / vol.max() * 50000 + r.integers(0, 500, vol.shape)).astype(
        np.uint16)


def test_program_spans_name_the_idle_time_of_a_dog_call(cuda):
    """The benchmark's trace analysis (``portbench/harness/trace.py``) of
    one DoG call at the benchmark's frame size names at least 95% of the
    card's idle time by the program's leaf spans. A call runs before the
    analysed one inside the profile, as in the benchmark's tail, so that
    the analysed call's first gap has a span before it."""
    import sys

    from iterseg_tpu_torch import utils
    from iterseg_tpu_torch.engine.segmentation import dog_blob_watershed

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench"))
    from harness import trace

    vol = platelet_frame(0)

    def call():
        return dog_blob_watershed(None, vol, None, "t", None, debug=True)

    call()
    with trace.profiled() as prof:
        call()
        with torch.profiler.record_function("portbench.call"):
            call()
    got = trace.analyse(prof)
    idle = got["window_s"] - got["busy_s"]
    named = sum(s for k, s in got["idle_gaps"]
                if k.startswith("call: after " + utils.PREFIX))
    assert idle > 0 and named >= 0.95 * idle, got["idle_gaps"]
    assert {s["name"] for s in utils.spans()} >= {"call", "frame", "entry",
                                                   "dispatch", "flood"}


@pytest.fixture(scope="module")
def platelet_stack():
    """Six frames at the benchmark's size (made once a module)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return np.stack([platelet_frame(seed) for seed in range(6)])


def each_frame_alone(stack, device):
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed

    return np.stack([np.asarray(affinity_unet_watershed(
        None, frame, None, "f", None, debug=True, devices=[device]))
        for frame in stack])


def test_stack_on_frame_streams_equals_each_frame_alone(platelet_stack,
                                                        cuda):
    """A 6-frame stack, each frame on a stream of its own, gives the
    labels of each frame segmented alone (on the default stream)."""
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed

    got = np.asarray(affinity_unet_watershed(
        None, platelet_stack, None, "s", None, debug=True, devices=[cuda]))
    want = each_frame_alone(platelet_stack, cuda)
    assert want.max() > 100
    np.testing.assert_array_equal(got, want)


def test_two_card_stack_on_frame_streams_equals_each_frame_alone(
        platelet_stack, two_cards):
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed

    got = np.asarray(affinity_unet_watershed(
        None, platelet_stack, None, "s", None, debug=True,
        devices=two_cards))
    np.testing.assert_array_equal(
        got, each_frame_alone(platelet_stack, two_cards[0]))


def test_frame_dispatch_does_not_wait_for_the_card(platelet_stack, cuda,
                                                   monkeypatch):
    """Right after a frame's dispatch returns, its stream still has work
    queued, and the dispatch made no synchronising call (CUDA's sync debug
    mode raises on one); the frames take turns on two streams, neither the
    default one, and each counts ``async_dispatch``."""
    from iterseg_tpu_torch import utils
    from iterseg_tpu_torch.engine import device_pipeline as dp
    from iterseg_tpu_torch.engine.predict import load_unet

    pipe = dp.AffinityPipeline(load_unet(None), device=cuda)
    pipe.model.module(cuda)  # the replica's pageable build, done before
    real, queued, streams = dp._drive_stack, [], []

    def spy(stack, out, skip, devices, dispatch_one, finalize_one, own=None):
        def dispatch(t, device):
            torch.cuda.set_sync_debug_mode("error")
            try:
                job = dispatch_one(t, device)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            stream = torch.cuda.current_stream()
            queued.append(not stream.query())
            streams.append(stream.stream_id)
            return job
        return real(stack, out, skip, devices, dispatch, finalize_one, own)

    monkeypatch.setattr(dp, "_drive_stack", spy)
    out = np.zeros(platelet_stack[:4].shape, np.int32)
    utils.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert list(pipe.segment_stack(platelet_stack[:4], out,
                                       devices=[cuda])) == [0, 1, 2, 3]
    assert queued == [True] * 4
    assert streams[0] == streams[2] != streams[1] == streams[3]
    assert torch.cuda.default_stream().stream_id not in streams
    assert out.max() > 100
    counted = [s["frame"] for s in utils.spans()
               if s["name"] == "async_dispatch"]
    assert sorted(counted) == [0, 1, 2, 3]


@pytest.mark.parametrize("normalize", [True, False])
def test_whole_frame_upload_equals_slab_by_slab_on_card(platelet_stack, cuda,
                                                        normalize):
    """The feature program's pinned whole-frame upload gives the features
    of the pageable slab-by-slab uploads bit for bit, at the benchmark's
    frame, chunk and microbatch."""
    from iterseg_tpu_torch.engine import device_pipeline as dp
    from iterseg_tpu_torch.engine.predict import load_unet

    vol = platelet_stack[0]
    program = dp.get_feature_program(load_unet(None), vol.shape,
                                     normalize=normalize, device=cuda)
    assert len(set(program.slab_of)) > 1
    got = program(vol, cuda)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dp, "_upload_frame", slab_by_slab(program))
        want = program(vol, cuda)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dims,width,heads,shifted", [
    ((48, 48, 48), 48, 3, False), ((48, 48, 48), 48, 3, True),
    ((12, 4, 12), 48, 3, True), ((6, 6, 6), 384, 24, False)])
def test_window_attention_kernel_matches_the_reference(cuda, dims, width,
                                                       heads, shifted):
    """The CUDA window-attention kernel against its plain version (the
    scores in memory) at stage 0 of a 96^3 chunk (C 48, 3 heads, 48^3
    tokens padded to 49^3, 7^3 windows, unshifted and shifted), a clipped
    axis in a shifted block, and stage 3's single clipped 6^3 window (C 384,
    24 heads); and one whole block of the program against the reference's
    (``portbench/reference/swin_unetr.py``). 1e-5: float32 products summed
    in another order and the online softmax's rescaling on O(1) outputs
    (2.1e-6 measured)."""
    import sys

    from iterseg_tpu_torch.device import f32_numerics
    from iterseg_tpu_torch.models import swin_unetr as swin
    from iterseg_tpu_torch.ops import window_attention as wa

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench"))
    from reference import swin_unetr as ref

    window, shift = swin.window_and_shift(dims, shifted)
    grid = tuple(-(-d // w) * w for d, w in zip(dims, window))
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((2,) + grid + (3 * width,), device=cuda, generator=gen)
    table = torch.randn((13 ** 3, heads), device=cuda, generator=gen)
    before = wa.launches()
    with f32_numerics():
        got = wa.window_attention(qkv, table, heads, window, shift)
        want = wa.window_attention_plain(qkv, table, heads, window, shift)
    assert wa.launches() == before + 1
    assert float((got - want).abs().max()) <= 1e-5

    block = swin.SwinBlock(width, heads, shifted).to(cuda)
    with torch.no_grad():
        block.attn.relative_position_bias_table.copy_(table * 0.02)
    x = torch.randn((1,) + dims + (width,), device=cuda, generator=gen)
    p = {"b." + k: v for k, v in block.state_dict().items()}
    with torch.no_grad(), f32_numerics():
        got = block(x)
        want = ref._block(p, "b.", x, shifted)
    assert float((got - want).abs().max()) <= 1e-5
