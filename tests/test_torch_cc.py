"""The port's on-device labeller (``iterseg_tpu_torch.ops.cc``) against
scipy, the port's host labeller and the JAX package's XLA labeller, on the
CPU: labels bit-equal (scipy's raster numbering), the true count, and the
overflow retry when there are more components than ``max_labels``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu.ops import cc as jcc
from iterseg_tpu_torch.ops import cc as tcc
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
CASES = [((6, 20, 24), 0.5, 0), ((8, 16, 16), 0.3, 1), ((1, 1, 5), 0.5, 2),
         ((4, 4, 4), 0.0, 3), ((3, 9, 11), 0.9, 4), ((12, 12), 0.45, 5)]


def mask_of(shape, p, seed):
    return np.random.default_rng(seed).random(shape) < p


@pytest.mark.parametrize("shape,p,seed", CASES)
def test_label_device_equals_label_np_scipy_and_jax(shape, p, seed):
    m = mask_of(shape, p, seed)
    got, num = tcc.label_device(m, device=CPU)
    assert got.dtype == torch.int32 and num.dtype == torch.int32
    want, n = ndi.label(m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(num) == n
    if m.ndim == 3:
        host, n_host = tcc.label_np(m)
        np.testing.assert_array_equal(got.numpy(), host)
        assert int(num) == n_host
    jl, jn = jcc.label_device(jnp.asarray(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jl))
    assert int(num) == int(jn)


@pytest.mark.parametrize("shape,p,seed", [((6, 20, 24), 0.5, 0),
                                          ((8, 16, 16), 0.3, 1),
                                          ((5, 12, 12), 0.2, 9),
                                          ((30, 40), 0.4, 10)])
def test_overflow_retry(shape, p, seed):
    """With ``max_labels`` below the count, ``label_jax`` truncates the
    renumbering exactly as JAX's does and reports the true count;
    ``label_device`` retries and gets scipy's labels."""
    m = mask_of(shape, p, seed)
    want, n = ndi.label(m)
    assert n > 3
    trunc, num = tcc.label_jax(torch.from_numpy(m), max_labels=3)
    jtrunc, jnum = jcc.label_jax(jnp.asarray(m), max_labels=3)
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    assert int(num) == int(jnum) == n
    got, num = tcc.label_device(m, max_labels=3, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(num) == n


def test_component_roots_are_min_indices():
    m = mask_of((5, 9, 7), 0.5, 6)
    roots = tcc.component_roots(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(
        roots, np.asarray(jcc.component_roots(jnp.asarray(m))))
    labels, n = ndi.label(m)
    flat = np.arange(m.size).reshape(m.shape)
    for i in range(1, n + 1):
        assert (roots[labels == i] == flat[labels == i].min()).all()
    assert (roots[~m] == m.size).all()


def test_tensor_input_stays_on_its_device():
    m = torch.from_numpy(mask_of((4, 8, 8), 0.5, 7))
    got, _ = tcc.label_device(m)  # a tensor needs no device argument
    assert got.device == m.device


@pytest.mark.parametrize("min_size", [0, 2, 5, 30])
def test_component_sizes_and_remove_small_objects_equal_jax(min_size):
    labels, _ = ndi.label(mask_of((6, 20, 24), 0.45, 8))
    np.testing.assert_array_equal(tcc.component_sizes(labels),
                                  jcc.component_sizes(labels))
    np.testing.assert_array_equal(
        tcc.component_sizes(torch.from_numpy(labels)),
        jcc.component_sizes(labels))
    np.testing.assert_array_equal(
        tcc.remove_small_objects(labels, min_size),
        jcc.remove_small_objects(labels, min_size))
    np.testing.assert_array_equal(
        tcc.remove_small_objects(torch.from_numpy(labels), min_size),
        jcc.remove_small_objects(labels, min_size))
