"""The port's training (losses, train-mode BatchNorm, the full network's
train step, Adam, ``train_unet``) against the JAX package on the same
seeded inputs.

Tolerances:
- losses: values within 1e-5 relative; gradients finite and within 1e-5 x
  the largest gradient of ``jax.grad``;
- train-mode BatchNorm alone against ``batchnorm_train``: output, running
  stats and gradients within 1e-5;
- the full network (JAX ``init_params(UNetSpec(1, 5), seed=0)`` carried
  across) on a (1, 1, 4, 16, 16) batch: train-mode forward within 5e-4
  max-abs (the forward bound), BCE loss and new running stats within 1e-5
  relative (of each statistic's largest magnitude), every gradient within
  ``GRAD_BOUND`` x the largest gradient. Train-mode BatchNorm amplifies
  float noise into the gradients: with two torch threads the measured
  worst gradient residual is recorded as the junit property
  ``grad_resid_rel`` (1.2e-6 of the largest gradient in a CPU run; the
  forward's max-abs, ``forward_max_abs``, 1.5e-6);
- two Adam steps on fixed gradients against two ``optax.adam`` updates:
  within 1e-5 (the bound ``tests/test_train.py`` uses against torch);
- ``train_unet``: the epoch-0 validation loss and the first training loss,
  both taken before any update, within 1e-5 relative.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu.models.convert import load_checkpoint as jax_load
from iterseg_tpu.models.unet import UNetSpec as JaxSpec
from iterseg_tpu.models.unet import apply as jax_apply
from iterseg_tpu.models.unet import batchnorm_train, forward, init_params
from iterseg_tpu.train import losses as jl
from iterseg_tpu.train import train as jax_train
from iterseg_tpu.train.labels import get_training_labels as jax_labels
from iterseg_tpu_torch.engine.predict import load_unet
from iterseg_tpu_torch.models.convert import params_from_numpy
from iterseg_tpu_torch.models.unet import UNet, UNetSpec
from iterseg_tpu_torch.train import losses as tl
from iterseg_tpu_torch.train import train as torch_train
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
GRAD_BOUND = 1e-4  # x the largest gradient, ~80x the measured residual
CHANS = ("z-1", "y-1", "x-1", "mask", "centreness-log")


def loss_inputs(seed=0, shape=(1, 5, 2, 8, 8)):
    """Predictions with exact 0s and 1s among them, and {0, 1} targets."""
    r = np.random.default_rng(seed)
    x = r.random(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0
    flat[3::11] = 1.0
    y = (r.random(shape) > 0.5).astype(np.float32)
    return x, y


LOSSES = {
    "BCELoss": {},
    "DiceLoss": {},
    "MSELoss": {},
    "WeightedBCE": {"chan_weights": [0.5, 1.0, 2.0, 1.0, 3.0]},
    "EpochWeightedBCE": {"chan_weights": [[1.0] * 5, [2.0, 1.0, 0.5, 1.0,
                                                      3.0]]},
    "Channelwise": {"losses": ["BCELoss", "DiceLoss", "MSELoss"],
                    "chan_losses": [[0, 1, 2], [3], [4]]},
}


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name, epoch):
    x, y = loss_inputs(seed=len(name) + epoch)
    jfn = jl.make_loss_function(name, **LOSSES[name])
    tfn = tl.make_loss_function(name, **LOSSES[name])
    want, jgrad = jax.value_and_grad(
        lambda a: jfn(a, jnp.asarray(y), epoch))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt, torch.from_numpy(y), epoch)
    got.backward()
    got = float(got.detach())
    assert abs(got - float(want)) <= 1e-5 * abs(float(want))
    jgrad = np.asarray(jgrad)
    tgrad = xt.grad.numpy()
    assert np.isfinite(tgrad).all()
    np.testing.assert_allclose(tgrad, jgrad, rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())


@pytest.mark.parametrize("name", ["BCELoss", "DiceLoss"])
def test_channel_losses_match_jax(name):
    """Per-channel logging applies the loss to the 4D slice y_hat[:, i]
    (Dice flattens over z there), as the JAX package does."""
    x, y = loss_inputs(seed=9)
    jfn, tfn = jl.make_loss_function(name), tl.make_loss_function(name)
    want = [float(v) for v in jl.channel_losses(jnp.asarray(x),
                                                jnp.asarray(y), jfn, 5)]
    got = [float(v) for v in tl.channel_losses(torch.from_numpy(x),
                                               torch.from_numpy(y), tfn, 5)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bce_gradient_is_zero_where_saturated():
    x = torch.tensor([0.0, 1.0, 0.5, 1e-45, 1e-7, 1.0 - 1e-7],
                     requires_grad=True)
    y = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0, 0.0])
    tl.bce_loss(x, y).backward()
    assert torch.isfinite(x.grad).all()
    assert x.grad[0] == 0 and x.grad[1] == 0


def test_train_batchnorm_matches_jax():
    r = np.random.default_rng(3)
    x = r.random((1, 8, 4, 8, 8)).astype(np.float32)
    w = r.uniform(0.5, 1.5, 8).astype(np.float32)
    b = r.uniform(-0.5, 0.5, 8).astype(np.float32)
    rm = r.uniform(-0.1, 0.1, 8).astype(np.float32)
    rv = r.uniform(0.5, 1.5, 8).astype(np.float32)

    def f(w_, b_, x_):
        out, nm, nv = batchnorm_train(x_, w_, b_, jnp.asarray(rm),
                                      jnp.asarray(rv))
        return jnp.mean(out ** 2), (out, nm, nv)

    (_, (jout, jm, jv)), jg = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    bn = torch.nn.BatchNorm3d(8).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.running_mean.copy_(torch.from_numpy(rm))
        bn.running_var.copy_(torch.from_numpy(rv))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = bn(xt)
    (out ** 2).mean().backward()
    for got, want in ((out.detach(), jout), (bn.running_mean, jm),
                      (bn.running_var, jv), (bn.weight.grad, jg[0]),
                      (bn.bias.grad, jg[1]), (xt.grad, jg[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_conv_module_switches_batchnorm_mode():
    """Eval mode is the folded running-stat form; train mode normalises
    with the batch statistics and moves the running stats."""
    net = UNet(UNetSpec(1, 2)).init_weights(1)
    m = net.c0
    x = torch.from_numpy(np.random.default_rng(1).random(
        (1, 1, 2, 8, 8)).astype(np.float32))
    rm = m.batch0.running_mean.clone()
    with torch.no_grad():
        m(x)
        assert torch.equal(m.batch0.running_mean, rm)
        m.train()
        m(x)
    assert not torch.equal(m.batch0.running_mean, rm)


def test_init_weights_follows_init_params():
    """Same shapes and keys as the JAX init, kaiming-uniform bounds of
    1/sqrt(fan-in) (a = sqrt(5)), BatchNorm at 1/0, and a seed that
    decides the draw."""
    spec = UNetSpec(1, 5)
    net = UNet(spec).init_weights(0)
    jp = init_params(JaxSpec(1, 5), seed=0)
    sd = {k: v for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert set(sd) == set(jp)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(jp[k].shape), k
    for k, fan_in in (("c0.conv0", 27), ("c5_0.conv0", 512 * 27),
                      ("up0", 8), ("up3", 4)):
        bound = 1 / np.sqrt(fan_in)
        w = sd[f"{k}.weight"].abs().max().item()
        assert bound * 0.5 < w <= bound, k
        assert sd[f"{k}.bias"].abs().max().item() <= bound
    assert torch.equal(sd["c1.batch0.weight"], torch.ones(64))
    assert torch.equal(sd["c1.batch0.running_var"], torch.ones(64))
    again = UNet(spec).init_weights(0).state_dict()
    other = UNet(spec).init_weights(1).state_dict()
    assert torch.equal(again["c3.conv1.weight"], sd["c3.conv1.weight"])
    assert not torch.equal(other["c3.conv1.weight"], sd["c3.conv1.weight"])


def test_full_network_train_step_matches_jax(record_property):
    jp = init_params(JaxSpec(1, 5), seed=0)
    params = {k: np.asarray(v) for k, v in jp.items()}
    r = np.random.default_rng(0)
    x = r.random((1, 1, 4, 16, 16)).astype(np.float32)
    y = (r.random((1, 5, 4, 16, 16)) > 0.5).astype(np.float32)
    trainable, bn_state = jax_train._split_params(jp)

    def loss_wrapped(tr):
        out, upd = forward({**tr, **bn_state}, JaxSpec(1, 5), x, train=True)
        return jl.bce_loss(out, jnp.asarray(y)), (out, upd)

    (jloss, (jout, jupd)), jgrads = jax.value_and_grad(
        loss_wrapped, has_aux=True)(trainable)
    net = params_from_numpy(params).train()
    out = net(torch.from_numpy(x))
    loss = tl.bce_loss(out, torch.from_numpy(y))
    loss.backward()
    fwd = float(np.abs(out.detach().numpy() - np.asarray(jout)).max())
    record_property("forward_max_abs", fwd)
    print("train-mode forward max-abs", fwd)
    assert fwd <= 5e-4
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    sd = net.state_dict()
    assert len(jupd) == 9 * 2 * 2  # 9 conv modules, 2 BatchNorms each
    for k, want in jupd.items():
        want = np.asarray(want)
        diff = np.abs(sd[k].numpy() - want).max()
        assert diff <= 1e-5 * np.abs(want).max(), k
    grads = dict(net.named_parameters())
    assert set(grads) == set(jgrads)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    worst = max(float(np.abs(grads[k].grad.numpy()
                             - np.asarray(g)).max())
                for k, g in jgrads.items())
    record_property("grad_resid_rel", worst / gmax)
    print("train-mode gradient residual / largest gradient", worst / gmax)
    assert worst <= GRAD_BOUND * gmax


def test_double_adam_step_matches_optax():
    r = np.random.default_rng(2)
    p0 = {"a": r.standard_normal((32, 16)).astype(np.float32),
          "b": r.standard_normal(16).astype(np.float32)}
    g = {k: (0.1 * r.standard_normal(v.shape)).astype(np.float32)
         for k, v in p0.items()}
    opt = optax.adam(0.01, b1=0.9, b2=0.999, eps=1e-8)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    grads = {k: jnp.asarray(v) for k, v in g.items()}
    state = opt.init(params)
    for _ in range(2):
        u, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, u)
    ps = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in p0]
    adam = torch.optim.Adam(ps, lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    for p, k in zip(ps, p0):
        p.grad = torch.from_numpy(g[k].copy())
    adam.step()
    adam.step()
    for p, k in zip(ps, p0):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[k]), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_data():
    r = np.random.default_rng(0)
    vol = np.zeros((4, 32, 32), np.float32)
    pts = np.stack([r.integers(1, s - 1, size=6) for s in vol.shape], 1)
    vol[tuple(pts.T)] = 1.0
    img = ndi.gaussian_filter(vol, (1, 2, 2))
    img = img / img.max()
    gt, _ = ndi.label(img > 0.3)
    yvol = jax_labels(gt, CHANS, (4, 1, 1))
    crops = [(slice(0, 2), slice(0, 16), slice(0, 16)),
             (slice(2, 4), slice(16, 32), slice(8, 24)),
             (slice(1, 3), slice(8, 24), slice(16, 32))]
    xs = [np.ascontiguousarray(img[c]) for c in crops]
    ys = [np.ascontiguousarray(yvol[(slice(None),) + c]) for c in crops]
    return xs, ys


def test_train_unet_matches_jax(tiny_data, tmp_path, monkeypatch):
    xs, ys = tiny_data
    weights = {k: np.asarray(v)
               for k, v in init_params(JaxSpec(1, 5), seed=0).items()}
    kw = dict(x=xs[:2], vx=xs[2:], y=ys[:2], vy=ys[2:], name="t",
              channels=CHANS, epochs=2, lr=0.01, update_every=1,
              weights=weights)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    _, jpath = jax_train.train_unet(out_dir=str(jdir), **kw)
    saved = []
    save_output = torch_train._save_output

    def capture(y_hats, ids, out_dir, name=""):
        saved.extend(zip(ids, y_hats))
        return save_output(y_hats, ids, out_dir, name=name)

    monkeypatch.setattr(torch_train, "_save_output", capture)
    model, tpath = torch_train.train_unet(out_dir=str(tdir), device=CPU,
                                          **kw)
    for name in ("loss_t.csv", "validation-loss_t.csv"):
        j, t = pd.read_csv(jdir / name), pd.read_csv(tdir / name)
        assert list(j.columns) == list(t.columns) and len(j) == len(t)
    jl_, tl_ = pd.read_csv(jdir / "loss_t.csv"), pd.read_csv(
        tdir / "loss_t.csv")
    jv, tv = (pd.read_csv(d / "validation-loss_t.csv")
              for d in (jdir, tdir))
    assert len(tl_) == 4 and len(tv) == 3
    for a, b in ((tl_["loss"][0], jl_["loss"][0]),
                 (tv["validation_loss"][0], jv["validation_loss"][0])):
        assert abs(a - b) <= 1e-5 * abs(b)
    np.testing.assert_allclose(tl_[list(CHANS)].iloc[0],
                               jl_[list(CHANS)].iloc[0], rtol=1e-5)
    assert (tl_[["epoch", "batch_num"]] == jl_[["epoch", "batch_num"]]
            ).all().all()
    assert np.isfinite(tl_["loss"]).all()
    assert np.isfinite(tv["validation_loss"]).all()
    assert tl_["loss"][tl_["epoch"] == 1].mean() < tl_["loss"][
        tl_["epoch"] == 0].mean()
    # checkpoints: JAX's keys and shapes, no num_batches_tracked, per-epoch
    # files beside the final one, loadable by both packages
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert set(jz.files) == set(tz.files)
        assert all(jz[k].shape == tz[k].shape for k in jz.files)
    assert not any(k.endswith("num_batches_tracked")
                   for k in np.load(tpath).files)
    names = sorted(os.listdir(tdir))
    assert sum(n.endswith(("_unet_t_epoch-0.npz", "_unet_t_epoch-1.npz"))
               for n in names) == 2
    probe = np.random.default_rng(5).random((1, 1, 2, 16, 16)).astype(
        np.float32)
    got = load_unet(tpath)(probe, device=CPU).numpy()
    want = np.asarray(jax_apply(jax_load(tpath), JaxSpec(1, 5), probe))
    assert np.abs(got - want).max() <= 5e-4
    np.testing.assert_allclose(model(probe, device=CPU).numpy(), got,
                               rtol=0, atol=0)
    # validation TIFFs: JAX's names and page counts; PIL reads back the
    # port's own validation outputs bit for bit
    from PIL import Image

    jtifs = sorted(n for n in os.listdir(jdir) if n.endswith(".tif"))
    ttifs = sorted(n for n in os.listdir(tdir) if n.endswith(".tif"))
    assert jtifs == ttifs == ["t_val_0_validation_output.tif"]
    assert len(saved) == 1
    for name in ttifs:
        pages = []
        for d in (jdir, tdir):
            im = Image.open(d / name)
            pages.append(im.n_frames)
        assert pages[0] == pages[1] == 5 * 2
        im = Image.open(tdir / name)
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            assert im.mode == "F"
            frames.append(np.array(im))
        want = saved[0][1].reshape(-1, 16, 16)
        np.testing.assert_array_equal(np.stack(frames), want)


def test_train_unet_without_output_and_forked(tiny_data):
    """No out_dir: no files, no path; a forked spec trains too."""
    xs, ys = tiny_data
    model, path = torch_train.train_unet(
        x=xs[:1], vx=[], y=ys[:1], vy=[], epochs=1, validate=False,
        fork_channels=(3, 2), device=CPU)
    assert path is None and model.spec == UNetSpec(1, (3, 2))
    out = model(np.zeros((1, 1, 2, 16, 16), np.float32), device=CPU)
    assert out.shape == (1, 5, 2, 16, 16) and torch.isfinite(out).all()


@pytest.mark.parametrize("kw,error,match", [
    pytest.param({"mesh": object()}, TypeError, "Mesh", id="kw1"),
])
def test_sharded_training_raises(tiny_data, kw, error, match):
    """What sharded training refuses: a mesh must be a
    ``parallel.mesh.Mesh``."""
    xs, ys = tiny_data
    with pytest.raises(error, match=match):
        torch_train.train_unet(x=xs[:1], vx=[], y=ys[:1], vy=[],
                               device=CPU, **kw)


def test_profile_receives_step_times(tiny_data):
    xs, ys = tiny_data
    prof = {}
    torch_train.train_unet(x=xs[:2], vx=xs[2:], y=ys[:2], vy=ys[2:],
                           epochs=2, device=CPU, profile=prof)
    assert len(prof["step_s"]) == 4 and len(prof["validation_s"]) == 3
    assert len(prof["load_s"]) == 4 + 3
    assert all(s > 0 for s in prof["step_s"])
