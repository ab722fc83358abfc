"""The port's native host kernels (its own copy of priority_flood.cpp, built
into its own directory) against the JAX package's on synthetic blobs."""
import os

import numpy as np
import pytest
from scipy import ndimage as ndi

from iterseg_tpu import native as jnative
from iterseg_tpu.ops.watershed import affinity_watershed as jax_watershed
from iterseg_tpu_torch import native
from iterseg_tpu_torch._build import build_dir
from iterseg_tpu_torch.ops.cc import label_np, size_band_filter
from iterseg_tpu_torch.ops.watershed import affinity_watershed


def blob_case(shape=(14, 48, 48), n=18, seed=0):
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(3, s - 3, size=n) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 3, 3))
    vol /= vol.max()
    aff = np.stack([1.0 - vol + 0.01 * r.random(shape) for _ in range(3)])
    mask = np.pad(vol[1:-1, 1:-1, 1:-1] > 0.1, 1)
    peaks = np.argwhere((vol == ndi.maximum_filter(vol, size=5)) & mask)
    return aff.astype(np.float32), peaks, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affinity_watershed_equals_jax(seed):
    aff, coords, mask = blob_case(seed=seed)
    got = affinity_watershed(aff, coords, mask)
    want = jax_watershed(aff, coords, mask)
    assert native.loaded()
    assert got.max() == len(coords)
    np.testing.assert_array_equal(got, want)
    scaled = affinity_watershed(aff, coords, mask, scale=(2.0, 1.0, 1.0))
    np.testing.assert_array_equal(
        scaled, jax_watershed(aff, coords, mask, scale=(2.0, 1.0, 1.0)))


def test_python_oracle_fallback(monkeypatch):
    aff, coords, mask = blob_case(shape=(8, 24, 24), n=6, seed=3)
    want = affinity_watershed(aff, coords, mask)
    monkeypatch.setenv("ITERSEG_TORCH_NO_NATIVE", "1")
    with pytest.raises(native.NativeUnavailable):
        native.get_lib()
    np.testing.assert_array_equal(affinity_watershed(aff, coords, mask),
                                  want)
    np.testing.assert_array_equal(
        affinity_watershed(aff, coords, mask, py_func=True), want)


def test_library_is_built_outside_the_jax_package():
    lib = native.get_lib()
    path = os.path.realpath(lib._name)
    jax_pkg = os.path.realpath(os.path.dirname(jnative.__file__))
    assert not path.startswith(jax_pkg + os.sep)
    assert path.startswith(os.path.realpath(build_dir()) + os.sep)


def test_cc_and_band_filter_equal_jax():
    aff, coords, mask = blob_case(seed=4)
    labels, n = label_np(mask)
    want, wn = jnative.label_cc6(mask)
    assert n == wn
    np.testing.assert_array_equal(labels, want)
    got_mask, got_c = size_band_filter(mask, coords + 0, 50, 10 ** 7)
    filt = jnative.band_filter_cc6(mask.copy(), 50, 10 ** 7)
    np.testing.assert_array_equal(got_mask, filt)
    np.testing.assert_array_equal(got_c, coords[filt[tuple(coords.T)]])
    np.testing.assert_array_equal(
        native.band_filter_cc6(mask.copy(), 50, 10 ** 7), filt)
    keep = native.ensure_spacing_cheb(coords, 3)
    np.testing.assert_array_equal(keep, jnative.ensure_spacing_cheb(coords,
                                                                    3))
