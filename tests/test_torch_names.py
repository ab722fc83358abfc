"""Public names of the JAX package that the port adds in its last module
slice, each held against its JAX counterpart on the CPU:
``engine.predict.get_device`` and ``predict_chunk_feature_map`` (through
``process_chunks``, as ``tests/test_engine.py`` drives JAX's),
``train.labels.is_binary_channel`` over the channel grammar,
``native.band_filter_bfs`` (the BFS oracle of ``band_filter_cc6``) and
``models.unet.forked_unet_spec``."""
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu import native as jnative
from iterseg_tpu.models.unet import forked_unet_spec as jax_forked
from iterseg_tpu.train.labels import is_binary_channel as jax_binary
from iterseg_tpu_torch import native
from iterseg_tpu_torch.core.chunks import process_chunks
from iterseg_tpu_torch.engine import predict as tpredict
from iterseg_tpu_torch.models.convert import params_to_numpy
from iterseg_tpu_torch.models.unet import UNet, UNetSpec, forked_unet_spec
from iterseg_tpu_torch.train.labels import is_binary_channel
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")


def test_get_device_is_cuda_or_raises():
    assert "get_device" in tpredict.__all__
    if torch.cuda.is_available():
        assert tpredict.get_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tpredict.get_device()


def test_predict_chunk_feature_map_through_process_chunks():
    """The per-chunk driver gives ``predict_volume``'s features (batch-1
    forwards on both sides, so bit for bit)."""
    assert "predict_chunk_feature_map" in tpredict.__all__
    model = tpredict.UNetModel(params_to_numpy(
        UNet(UNetSpec(1, 5)).init_weights(0)))
    vol = np.random.default_rng(0).random((6, 96, 96)).astype(np.float32)
    fast = tpredict.predict_volume(model, vol, chunk_size=(6, 64, 64),
                                   margin=(1, 16, 16), batch_size=1,
                                   device=CPU)
    slow = np.zeros_like(fast)
    process_chunks(vol, (6, 64, 64), slow, (1, 16, 16),
                   tpredict.predict_chunk_feature_map,
                   config={"unet": model, "device": CPU})
    np.testing.assert_allclose(slow, fast, rtol=0, atol=1e-6)
    with pytest.raises(AssertionError, match="unet"):
        tpredict.predict_chunk_feature_map(vol[None], (slice(None),) * 4)


@pytest.mark.parametrize("chan", [
    "z-1", "y-2", "x-10", "z-1-smooth", "mask", "mask-smooth", "centreness",
    "centreness-log", "centreness-log-smooth", "centroid-gauss",
    "offsets-z", "offsets-y", "offsets-x", "z", "x-", "m", "y-1x"])
def test_is_binary_channel_equals_jax(chan):
    assert is_binary_channel(chan) == jax_binary(chan)


@pytest.mark.parametrize("seed", range(4))
def test_band_filter_bfs_equals_band_filter_cc6_and_jax(seed):
    """A band between the component sizes' terciles: some components stay,
    some go on either side."""
    r = np.random.default_rng(seed)
    mask = ndi.gaussian_filter(r.random((10, 40, 40)), 1.0) > 0.52
    labels, n = ndi.label(mask)
    sizes = np.sort(np.bincount(labels.ravel())[1:])
    lo, hi = int(sizes[n // 3]), int(sizes[2 * n // 3]) + 1
    bfs = native.band_filter_bfs(mask.copy(), lo, hi)
    np.testing.assert_array_equal(
        bfs, native.band_filter_cc6(mask.copy(), lo, hi))
    np.testing.assert_array_equal(
        bfs, jnative.band_filter_bfs(mask.copy(), lo, hi))
    assert bfs.dtype == bool and 0 < bfs.sum() < mask.sum()


@pytest.mark.parametrize("kw", [{}, {"fork_channels": (3, 2)},
                                {"in_channels": 2, "fork_channels": (4,)}])
def test_forked_unet_spec_equals_jax(kw):
    got, want = forked_unet_spec(**kw), jax_forked(**kw)
    assert got == UNetSpec(want.in_channels, want.out_channels)
    assert (got.in_channels, got.out_channels, got.finals, got.forked) == (
        want.in_channels, want.out_channels, tuple(want.finals),
        want.forked)
