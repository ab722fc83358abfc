"""The port's torch U-Net against the JAX model on the same weights.

Forward bound: max-abs <= 5e-4 (the cross-framework bound the JAX suite
pins in test_reference_identity.py); measured 6.6e-7 on the shipped
``default_unet.npz`` at a (10, 64, 64) input on the CPU with two torch
threads (the junit property ``max_abs``; the thread count sets the
summation order, so the last digits move with it)."""
import numpy as np
import pytest
import torch

from iterseg_tpu.engine.predict import DEFAULT_UNET_PATH as JAX_DEFAULT
from iterseg_tpu.models.convert import load_checkpoint as jax_load
from iterseg_tpu.models.unet import UNetSpec as JaxSpec
from iterseg_tpu.models.unet import apply as jax_apply
from iterseg_tpu.models.unet import init_params
from iterseg_tpu_torch.engine.predict import DEFAULT_UNET_PATH, load_unet
from iterseg_tpu_torch.models.convert import (
    infer_spec_from_params,
    load_checkpoint,
    params_from_numpy,
    params_to_numpy,
    save_checkpoint,
)
from iterseg_tpu_torch.models.unet import UNetSpec
from torch_threads import two_torch_threads  # noqa: F401

BOUND = 5e-4


@pytest.fixture(scope="module")
def params():
    return load_checkpoint(DEFAULT_UNET_PATH)


def test_default_checkpoint_is_the_jax_one(params):
    import os

    assert os.path.samefile(DEFAULT_UNET_PATH, JAX_DEFAULT)
    jp = jax_load(JAX_DEFAULT)
    assert set(params) == set(jp) and len(params) == 116
    assert sum(v.size for v in params.values()) == 9976533


def test_forward_matches_jax(params, record_property):
    x = np.random.default_rng(0).random((1, 1, 10, 64, 64)).astype(
        np.float32)
    with torch.no_grad():
        got = params_from_numpy(params)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_apply(jax_load(JAX_DEFAULT), JaxSpec(1, 5), x))
    assert got.shape == want.shape == (1, 5, 10, 64, 64)
    resid = float(np.abs(got - want).max())
    record_property("max_abs", resid)
    assert resid <= BOUND


def test_forked_forward_matches_jax():
    spec = JaxSpec(1, (3, 2))
    jp = init_params(spec, seed=3)
    p = {k: np.asarray(v) for k, v in jp.items()}
    assert infer_spec_from_params(p) == UNetSpec(1, (3, 2))
    x = np.random.default_rng(1).random((2, 1, 4, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = params_from_numpy(p)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_apply(jp, spec, x))
    assert got.shape == want.shape == (2, 5, 4, 32, 32)
    assert np.abs(got - want).max() <= BOUND


def test_params_round_trip(params, tmp_path):
    net = params_from_numpy(params)
    back = params_to_numpy(net)
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    pt = save_checkpoint(params, str(tmp_path / "u.pt"))
    again = load_checkpoint(pt)
    for k in params:
        np.testing.assert_array_equal(again[k], params[k])
    # the transpose-conv weights keep torch's grouped layout (C, 1, k...)
    assert tuple(net.up0.weight.shape) == (256, 1, 2, 2, 2)
    assert tuple(net.up3.weight.shape) == (32, 1, 1, 2, 2)


def test_params_from_numpy_rejects_bad_keys(params):
    bad = dict(params)
    bad["c0.conv0.extra"] = np.zeros(1, np.float32)
    with pytest.raises(RuntimeError):
        params_from_numpy(bad)


def test_orbax_directory_raises(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(str(tmp_path))


def test_unet_model_bf16_runs():
    model = load_unet(None, compute_dtype="bfloat16")
    assert model.compute_dtype == torch.bfloat16
    x = np.random.default_rng(2).random((1, 1, 2, 16, 16)).astype(np.float32)
    y = model(x, device=torch.device("cpu"))
    assert y.dtype == torch.float32 and y.shape == (1, 5, 2, 16, 16)
    assert torch.isfinite(y).all()
