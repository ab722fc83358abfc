"""The port's training labels against the JAX package on the same ground
truth: every channel of the grammar bit-equal, except the Gaussian-smoothed
ones (``-smooth`` and ``centroid-gauss``), held within 2.4e-7 — the jit
FMA residual of the Gaussian already logged for
``test_torch_ops.py::test_gaussian``."""
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu.train import labels as jlab
from iterseg_tpu_torch.train import labels as tlab
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
SMOOTH_BOUND = 2.4e-7

CHANNELS = ["z-1", "z-2", "y-1", "y-2", "x-1", "x-3", "mask", "centreness",
            "centreness-log", "centroid-gauss", "offsets-z", "offsets-y",
            "offsets-x", "z-1-smooth", "x-2-smooth", "mask-smooth",
            "centreness-smooth", "centreness-log-smooth"]


@pytest.fixture(scope="module")
def gt():
    r = np.random.default_rng(7)
    vol = np.zeros((4, 32, 32), np.float32)
    pts = np.stack([r.integers(0, s, size=8) for s in vol.shape], 1)
    vol[tuple(pts.T)] = 1.0
    img = ndi.gaussian_filter(vol, (1, 2, 2))
    labels, n = ndi.label(img > 0.2 * img.max())
    # a single-voxel object: its centreness is NaN -> 0 in both packages
    labels[0, 0, 0] = n + 1
    return labels


@pytest.mark.parametrize("chan", CHANNELS)
def test_channel_matches_jax(gt, chan):
    scale = (4, 1, 1)
    want = jlab.get_training_labels(gt, (chan,), scale)
    got = tlab.get_training_labels(gt, (chan,), scale, device=CPU)
    assert got.shape == want.shape == (1,) + gt.shape
    assert got.dtype == want.dtype
    if chan.endswith("-smooth") or chan == "centroid-gauss":
        assert np.abs(got - want).max() <= SMOOTH_BOUND
    else:
        np.testing.assert_array_equal(got, want)


def test_stack_of_channels_matches_jax(gt):
    chans = ("z-1", "y-1", "x-1", "mask", "centreness-log")
    want = jlab.get_training_labels(gt, chans, (4, 1, 1))
    got = tlab.get_training_labels(gt, chans, (4, 1, 1), device=CPU)
    np.testing.assert_array_equal(got, want)


def test_unknown_channel_raises(gt):
    with pytest.raises(ValueError, match="Unrecognised channel"):
        tlab.get_training_labels(gt, ("banana",), device=CPU)


@pytest.mark.parametrize("sigma", [1, 2])
def test_smooth_matches_jax(gt, sigma):
    img = (gt > 0).astype(np.float64)
    want = jlab.smooth(img, sigma=sigma)
    got = tlab.smooth(img, sigma=sigma, device=CPU)
    assert got.dtype == np.float32 == want.dtype
    assert np.abs(got - want).max() <= SMOOTH_BOUND
