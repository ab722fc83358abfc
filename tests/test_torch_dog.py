"""The port's DoG-path ops against the JAX package on the same inputs.

- ``gaussian_laplace``, ``dog_image``, ``smooth_planes``: bit-equal to the
  JAX filters evaluated op by op (``jax.disable_jit``). Under ``jax.jit``
  XLA:CPU contracts some multiply-adds into FMAs; the stated tolerance
  against jitted JAX is max-abs <= 2.4e-7 (2 ulp of 1.0) on images in
  [0, 1], as for the Gaussian in ``test_torch_ops`` (measured <= 1.2e-7).
- The n-D ``maximum_filter`` (the 4D DoG cube) and ``edt_sq`` (with chunks
  forced small, on an axis of 64): exact, bit-equal.
- ``peak_local_max`` on the 4D cube with a per-axis ``exclude_border``,
  ``blob_dog`` and ``blob_log``: equal rows.
- ``image_watershed``: bit-equal; ``bucket_flood_image`` gives
  ``image_watershed``'s labels on −EDT below its key bound.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu.ops import blob as jb
from iterseg_tpu.ops import edt as jedt
from iterseg_tpu.ops import filters as jf
from iterseg_tpu.ops import peaks as jpk
from iterseg_tpu.ops import watershed as jw
from iterseg_tpu_torch import native
from iterseg_tpu_torch.ops import blob as tb
from iterseg_tpu_torch.ops import edt as tedt
from iterseg_tpu_torch.ops import filters as tf
from iterseg_tpu_torch.ops import peaks as tpk
from iterseg_tpu_torch.ops import watershed as tw
from iterseg_tpu_torch.ops.watershed_oracle import neighbor_offsets

from test_device_flood import edt_case
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
GAUSS_TOL = 2.4e-7


def blob_image(shape=(10, 40, 40), n=12, seed=0):
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(2, s - 2, size=n) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 2, 2))
    return (vol / vol.max()).astype(np.float32)


def held_against_jax(got, fn, record_property):
    """Bit-equal to ``fn()`` op by op; within ``GAUSS_TOL`` of jitted
    ``fn()``."""
    with jax.disable_jit():
        eager = np.asarray(fn())
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(fn())
    resid = float(np.abs(got - jitted).max())
    record_property("max_abs_vs_jit", resid)
    assert resid <= GAUSS_TOL


@pytest.mark.parametrize("sigma", [1.0, 2.5, (1.0, 1.0, 1.5)])
def test_gaussian_laplace(sigma, record_property):
    x = blob_image(seed=1)
    got = tf.gaussian_laplace(torch.from_numpy(x), sigma).numpy()
    held_against_jax(got, lambda: jf.gaussian_laplace(x, sigma),
                     record_property)


def test_gaussian_laplace_reflects_past_short_axes():
    # radius 12 on an axis of 5: numpy's symmetric padding repeats
    x = blob_image(shape=(5, 16, 16), seed=2)
    with jax.disable_jit():
        want = np.asarray(jf.gaussian_laplace(x, 3.0))
    np.testing.assert_array_equal(
        tf.gaussian_laplace(torch.from_numpy(x), 3.0).numpy(), want)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 3.7])
def test_gaussian_kernel1d_order2(sigma):
    np.testing.assert_array_equal(tf.gaussian_kernel1d_order2(sigma),
                                  jf.gaussian_kernel1d_order2(sigma))


def test_dog_image(record_property):
    x = blob_image(seed=3)
    got = tf.dog_image(torch.from_numpy(x), 1, 1.5).numpy()
    held_against_jax(got, lambda: jf.dog_image(x, 1, 1.5), record_property)


def test_smooth_planes(record_property):
    x = blob_image(seed=4)
    got = tf.smooth_planes(torch.from_numpy(x), 0, 1.5).numpy()
    held_against_jax(got, lambda: jf.smooth_planes(x, 0, 1.5),
                     record_property)


@pytest.mark.parametrize("shape", [(8, 20, 24, 3), (6, 30, 2)])
def test_maximum_filter_nd(shape):
    r = np.random.default_rng(5)
    x = np.round(r.random(shape) * 8).astype(np.float32)  # many plateaus
    np.testing.assert_array_equal(
        tf.maximum_filter(torch.from_numpy(x), 3).numpy(),
        np.asarray(jf.maximum_filter(x, 3)))


@pytest.mark.parametrize("chunk_elems", [1 << 26, 5000])
def test_edt_sq_bit_equal(chunk_elems, monkeypatch):
    monkeypatch.setattr(tedt, "_CHUNK_ELEMS", chunk_elems)
    _, _, mask = edt_case(shape=(9, 30, 64), seed=1)
    mask[:, :, 20:] |= True  # long runs without a zero on the x lines
    got = tedt.edt_sq(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jedt.edt_sq(mask)))
    np.testing.assert_array_equal(
        np.sqrt(got.astype(np.float64)), ndi.distance_transform_edt(mask))
    np.testing.assert_array_equal(
        tedt.edt(torch.from_numpy(mask)).numpy(),
        np.asarray(jedt.edt(mask)))


def test_edt_np_and_native_edt3d():
    _, _, mask = edt_case(seed=2)
    want = ndi.distance_transform_edt(mask)
    np.testing.assert_array_equal(tedt.edt_np(mask), want)
    np.testing.assert_array_equal(native.edt3d(mask), want)


def test_peak_local_max_4d_cube():
    x = blob_image(shape=(8, 32, 32), n=10, seed=6)
    cube = np.stack([np.asarray(jf.gaussian(x, s)) for s in (1.0, 1.6, 2.56)],
                    axis=-1)
    cube = cube[..., :-1] - cube[..., 1:]
    counts = []
    for border in (False, (1, 2, 0, 0), 1):
        got = tpk.peak_local_max(cube, threshold_abs=0.003,
                                 exclude_border=border, device=CPU)
        want = jpk.peak_local_max(cube, threshold_abs=0.003,
                                  exclude_border=border)
        np.testing.assert_array_equal(got, want)
        counts.append(len(want))
    assert counts[0] > 3 and counts[1] > 0 and counts[2] == 0


@pytest.mark.parametrize("seed", [7, 8])
def test_blob_dog(seed):
    x = blob_image(seed=seed)
    got = tb.blob_dog(x, min_sigma=1, max_sigma=1.5, threshold=0.02,
                      device=CPU)
    with jax.disable_jit():
        want = jb.blob_dog(x, min_sigma=1, max_sigma=1.5, threshold=0.02)
    assert len(want) > 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(max_sigma=4, num_sigma=4),
                                dict(max_sigma=5, num_sigma=3,
                                     log_scale=True)])
def test_blob_log(kw):
    x = blob_image(seed=9)
    got = tb.blob_log(x, min_sigma=1, threshold=0.05, device=CPU, **kw)
    with jax.disable_jit():
        want = jb.blob_log(x, min_sigma=1, threshold=0.05, **kw)
    assert len(want) > 3
    np.testing.assert_array_equal(got, want)


def test_blob_empty_results():
    x = np.zeros((6, 16, 16), np.float32)
    assert tb.blob_dog(x, threshold=0.1, device=CPU).shape == (0, 4)
    assert tb.blob_log(x, max_sigma=3, num_sigma=2, threshold=0.1,
                       device=CPU).shape == (0, 4)


@pytest.mark.parametrize("seed", [0, 3])
def test_image_watershed(seed):
    image, markers, mask = edt_case(seed=seed)
    got = tw.image_watershed(image, markers, mask)
    np.testing.assert_array_equal(
        got, jw.image_watershed(image, markers, mask))
    np.testing.assert_array_equal(
        tw.image_watershed(image, markers, mask, py_func=True), got)


def test_bucket_flood_equals_image_watershed():
    _, markers, mask = edt_case(seed=5)
    dist_sq = np.asarray(jedt.edt_sq(mask)).astype(np.int64)
    want = tw.image_watershed(-np.sqrt(dist_sq.astype(np.float64)), markers,
                              mask)
    pad = lambda a: np.pad(a, 1)  # noqa: E731
    mask_w = pad(mask)
    output = np.where(mask_w, pad(markers), 0).astype(np.int32).ravel()
    offsets, _ = neighbor_offsets(mask_w.shape)
    native.bucket_flood_image(pad(dist_sq).astype(np.int32).ravel(), offsets,
                              np.flatnonzero(output), mask_w.ravel(), output)
    got = output.reshape(mask_w.shape)[1:-1, 1:-1, 1:-1]
    assert want.max() > 5
    np.testing.assert_array_equal(got, want)
    keys = np.full(mask_w.size, native.BUCKET_FLOOD_MAX_KEY, np.int32)
    with pytest.raises(ValueError, match="2\\^22"):
        native.bucket_flood_image(keys, offsets, np.flatnonzero(output),
                                  mask_w.ravel(), output)
