"""The port's feature-map ops against the JAX package on the same inputs.

- Gaussian: bit-equal to the JAX filter evaluated op by op (same taps, same
  accumulation order, edge padding). Under ``jax.jit`` XLA:CPU contracts some
  of the multiply-adds into FMAs, so the jitted JAX result differs by at most
  2 ulp: the stated tolerance is max-abs <= 2.4e-7 on images in [0, 1]
  (measured 1.8e-7).
- Max filter, Otsu, peak candidates and spacing: exact selection, bit-equal.
- Given the same float maps, ``segment_output_image`` gives bit-equal labels,
  seeds and mask.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu.ops import filters as jf
from iterseg_tpu.ops import peaks as jpk
from iterseg_tpu.ops import threshold as jt
from iterseg_tpu.ops import watershed as jw
from iterseg_tpu_torch.ops import filters as tf
from iterseg_tpu_torch.ops import peaks as tpk
from iterseg_tpu_torch.ops import threshold as tt
from iterseg_tpu_torch.ops import watershed as tw
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
GAUSS_TOL = 2.4e-7


def smooth_image(shape=(10, 48, 40), seed=0, sigma=2.0):
    r = np.random.default_rng(seed)
    x = ndi.gaussian_filter(r.random(shape).astype(np.float32), sigma)
    return (x - x.min()) / (x.max() - x.min())


@pytest.mark.parametrize("sigma", [2.0, (0.0, 1.0, 1.0), 1.0, 0.0])
def test_gaussian(sigma, record_property):
    x = smooth_image()
    got = tf.gaussian(torch.from_numpy(x), sigma).numpy()
    with jax.disable_jit():
        eager = np.asarray(jf.gaussian(x, sigma))
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(jf.gaussian(x, sigma))
    resid = float(np.abs(got - jitted).max())
    record_property("max_abs_vs_jit", resid)
    assert resid <= GAUSS_TOL


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0, 3.7])
def test_gaussian_kernel1d(sigma):
    np.testing.assert_array_equal(tf.gaussian_kernel1d(sigma),
                                  jf.gaussian_kernel1d(sigma))


def test_maximum_filter():
    x = smooth_image(seed=1)
    x[3, 5:9, 5:9] = 1.0  # a plateau
    np.testing.assert_array_equal(
        tf.maximum_filter(torch.from_numpy(x), 3).numpy(),
        np.asarray(jf.maximum_filter(x, 3)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otsu(seed):
    x = smooth_image(seed=seed)
    x = np.array(jf.gaussian(x, 2.0))
    got = tt.threshold_otsu(torch.from_numpy(x)).item()
    assert got == float(jt.threshold_otsu(x))
    assert np.float32(got) == np.float32(tt.threshold_otsu_np(x))


def test_otsu_edge_values_and_constant():
    # voxels exactly on interior bin edges (numpy's correction path)
    x = np.linspace(0, 1, 257, dtype=np.float32)
    x = np.concatenate([x, x[::7], np.float32([0.25, 0.5, 0.75] * 9)])
    got = tt.threshold_otsu(torch.from_numpy(x)).item()
    assert got == float(jt.threshold_otsu(x))
    counts, edges = tt._histogram_f32(torch.from_numpy(x), 256)
    want_counts, want_edges = np.histogram(x, 256)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(edges.numpy(), want_edges)
    c = np.full((4, 4), 0.3, np.float32)
    assert tt.threshold_otsu(torch.from_numpy(c)).item() == float(
        jt.threshold_otsu(c))


@pytest.mark.parametrize("seed", [0, 3])
def test_peak_local_max(seed):
    x = smooth_image(seed=seed, sigma=1.5)
    for thr in (0.04, 0.5):
        got = tpk.peak_local_max(x, threshold_abs=thr, device=CPU)
        want = jpk.peak_local_max(x, threshold_abs=thr)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tpk.peak_candidate_mask(torch.from_numpy(x), 0.3).numpy(),
        np.asarray(jpk.peak_candidate_mask(x, 0.3)))


def test_ensure_spacing_python_and_native():
    coords = np.random.default_rng(5).integers(0, 12, size=(300, 3))
    want = jpk._ensure_spacing(coords, 1)
    np.testing.assert_array_equal(tpk._ensure_spacing(coords, 1), want)
    np.testing.assert_array_equal(
        tpk._ensure_spacing(coords.astype(np.float64), 1),
        jpk._ensure_spacing(coords.astype(np.float64), 1))


def feature_maps(shape=(8, 64, 64), seed=4):
    """Saturated, U-Net-like maps: smooth blobs (mask, centroids) and
    boundary affinities."""
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(1, s - 1, size=25) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 3, 3))
    vol /= vol.max()
    edges = np.stack([np.abs(np.gradient(vol, axis=a)) for a in range(3)])
    aff = 1.0 - edges / edges.max()
    mask = 1 / (1 + np.exp(-40 * (vol - 0.15)))
    return np.concatenate([aff, mask[None], vol[None]]).astype(np.float32)


@pytest.mark.parametrize("absolute_thresh", [None, 0.5])
def test_segment_output_image(absolute_thresh):
    maps = feature_maps()
    got = tw.segment_output_image(maps, (0, 1, 2), 4, 3, device=CPU,
                                  absolute_thresh=absolute_thresh)
    want = jw.segment_output_image(maps, (0, 1, 2), 4, 3,
                                   absolute_thresh=absolute_thresh)
    assert got[0].max() > 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_segment_output_image_host_prep():
    maps = feature_maps(seed=6)
    got = tw.segment_output_image(maps, (0, 1, 2), 4, 3, device=CPU,
                                  device_featuremaps=False)
    want = jw.segment_output_image(maps, (0, 1, 2), 4, 3,
                                   device_featuremaps=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
