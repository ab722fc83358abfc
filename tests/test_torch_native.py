"""The port's native host kernels (its own copy of priority_flood.cpp, built
into its own directory) against the JAX package's on synthetic blobs."""
import os

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu import native as jnative
from iterseg_tpu.ops.watershed import affinity_watershed as jax_watershed
from iterseg_tpu_torch import native, utils
from iterseg_tpu_torch._build import build_dir
from iterseg_tpu_torch.ops.cc import label_np, size_band_filter
from iterseg_tpu_torch.ops.watershed import affinity_watershed
from iterseg_tpu_torch.ops.watershed_oracle import neighbor_offsets


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


def flood_case(name):
    """The arguments of a native flood (``output`` seeded) for one case of
    ``test_flood_queue_equals_the_heap``."""
    aff, coords, mask = blob_case(shape=(10, 96, 96), n=40, seed=5)
    shape = mask.shape
    offsets, axes = neighbor_offsets(shape)
    if name.startswith("image"):
        # image mode: -EDT-like priorities, the seeds at their own values
        prio = -np.round(ndi.distance_transform_edt(mask) * 2) / 2
        if name == "image_signed_zero":
            # every voxel at 0, half of them -0.0: age alone orders the pops
            sign = np.random.default_rng(6).random(prio.shape) < 0.5
            prio = np.where(sign, -0.0, 0.0)
        prio = prio.astype(np.float32).ravel()
        deep = prio < -1.0 if name == "image_negative" else True
        markers = np.flatnonzero(mask.ravel() & deep)[::97]
        values = prio[None]
        val_chan = np.zeros(len(offsets), np.int64)
        val_off = offsets
        seed_values = prio[markers]
    else:
        if name in ("quantised", "shuffled_seeds"):
            aff = np.round(aff * 7) / 7  # 8 levels: most pushes tie
        if name == "saturated":
            # a sigmoid of gain 40: most values in a few buckets near 1.0
            noise = ndi.gaussian_filter(
                np.random.default_rng(8).standard_normal(aff.shape), 2)
            aff = 1 / (1 + np.exp(-40 * noise / noise.std()))
        markers = np.ravel_multi_index(tuple(coords.T), shape)
        if name == "shuffled_seeds":
            # dense seeds out of index order: their ties fall to the index
            r = np.random.default_rng(7)
            markers = r.permutation(np.flatnonzero(mask.ravel()))[:400]
            assert (np.diff(markers) < 0).any()
        values = aff.reshape(3, -1).astype(np.float32)
        if name == "nan":
            values = values.copy()
            values[0, markers[0]] = np.nan  # read as the first seed pops
        val_chan = axes
        val_off = offsets.copy()
        val_off[:len(offsets) // 2] = 0
        seed_values = np.zeros(len(markers), np.float32)
    output = np.zeros(mask.size, np.int32)
    output[markers] = np.arange(1, len(markers) + 1, dtype=np.int32)
    return (values, offsets, val_chan, val_off, markers.astype(np.int64),
            seed_values, mask.ravel(), output)


@pytest.mark.parametrize("name", ["blob", "quantised", "saturated",
                                  "shuffled_seeds", "image_negative",
                                  "image_signed_zero", "nan"])
def test_flood_queue_equals_the_heap(name):
    """The bucketed queue gives the JAX package's native heap's labels voxel
    for voxel; a NaN value takes the heap, counted once."""
    *args, seeded = flood_case(name)
    want = jnative.priority_flood(*args, seeded.copy())
    assert (want > 0).sum() > 10 * len(args[4])
    utils.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = native.priority_flood(*args, seeded.copy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.priority_flood_heap(*args, seeded.copy()), want)
    counted = [(s["name"], s["value"]) for s in utils.spans()
               if s["kind"] == "counter"]
    assert counted == ([("flood_heap_fallback", 1)] if name == "nan" else [])


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
