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


def _uncached(bn, x):
    from iterseg_tpu_torch.models.unet import _bn_fold

    scale, shift = _bn_fold(bn, x.dtype)
    return x * scale + shift


def test_eval_batchnorm_keeps_its_fold_until_it_changes():
    """Eval BatchNorm outside autograd computes its fold once and gives the
    output of the fold computed afresh, bit for bit; a train-mode forward,
    an in-place change of a weight and autograd each make it compute the
    fold again."""
    from iterseg_tpu_torch.models.unet import BatchNorm

    r = torch.Generator().manual_seed(3)
    bn = BatchNorm(4)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(4, generator=r))
        bn.running_var.copy_(torch.rand(4, generator=r) + 0.5)
    x = torch.randn(2, 4, 3, 5, 5, generator=r)
    bn.eval()
    with torch.no_grad():
        first = bn(x)
        assert len(bn._folds) == 1
        kept = next(iter(bn._folds.values()))
        assert torch.equal(bn(x), first)
        assert next(iter(bn._folds.values())) is kept
        assert torch.equal(first, _uncached(bn, x))
        bn.train()
        bn(x * 3 + 1)  # moves the running statistics
        bn.eval()
        assert bn._folds == {}
        assert torch.equal(bn(x), _uncached(bn, x))
        assert not torch.equal(bn(x), first)
        bn.weight.mul_(2)
        assert torch.equal(bn(x), _uncached(bn, x))
    with torch.enable_grad():
        bn._folds = {}
        got = bn(x)
        assert bn._folds == {} and got.requires_grad
        with torch.no_grad():
            assert torch.equal(got, _uncached(bn, x))
