"""The port's device mesh (``iterseg_tpu_torch.parallel.mesh``) against the
JAX package's, on the CPU.

torch has one CPU device, so the port's meshes here list it twice
(``[cpu, cpu]``): every replica, split, gather and reduction runs as it
does over two cards. JAX's side runs on two of conftest's virtual CPU
devices.

- ``_factor2`` and the mesh shapes equal JAX's for 1..8 devices.
- ``sharded_predict_volume`` within 5e-4 of JAX's on a (2, 1) mesh, and
  bit-equal to the port's own ``predict_volume``.
- The data-parallel train step over ``[cpu, cpu]``, on seeds 0-2: in
  float32 its loss and gradients equal the port's one-device batch-2 step
  within 1e-6 of the largest gradient and JAX's global-batch ``jax.grad``
  within 1e-5, its running statistics the batch-2 step's within 1e-6.
  Readings on seeds 0, 1, 2 (largest gradient difference over the largest
  gradient; two and one torch threads): against the batch-2 step 6.1e-7,
  6.8e-7, 5.5e-7 (one thread 6.6e-7, 7.2e-7, 6.2e-7); against JAX 1.7e-6,
  1.5e-6, 1.6e-6 (one thread 1.7e-6, 1.5e-6, 1.5e-6). JAX itself cannot
  run the step in float64 (its BatchNorm computes in float32), so the
  float64 witness holds the step against the port's batch-2 step within
  1e-12.
- ``train_unet(mesh=...)`` on 2·dp+1 chunks: JAX's CSV columns, rows and
  ``data_id``s; the first loss within 1e-5 relative.
- The ``space`` axis is held in ``tests/test_torch_space.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterseg_tpu.engine.predict import UNetModel as JaxModel
from iterseg_tpu.models.unet import UNetSpec as JaxSpec
from iterseg_tpu.models.unet import forward as jax_forward
from iterseg_tpu.models.unet import init_params
from iterseg_tpu.parallel import mesh as jmesh
from iterseg_tpu.train import losses as jl
from iterseg_tpu.train import train as jax_train
from iterseg_tpu_torch.engine.predict import UNetModel, predict_volume
from iterseg_tpu_torch.models.convert import params_from_numpy
from iterseg_tpu_torch.models.unet import UNetSpec
from iterseg_tpu_torch.parallel import mesh as tmesh
from iterseg_tpu_torch.train import losses as tl
from iterseg_tpu_torch.train import train as torch_train
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
CHANNELS = ("z-1", "y-1", "x-1", "mask", "centreness")


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v) for k, v in
            init_params(JaxSpec(1, 5), seed=0).items()}


def two_cpus():
    return tmesh.Mesh([[CPU], [CPU]], ("data", "space"))


def jax_data_mesh(dp=2):
    return jax.sharding.Mesh(np.array(jax.devices()[:dp]).reshape(dp, 1),
                             ("data", "space"))


@pytest.mark.parametrize("n", range(1, 9))
def test_factor2_and_mesh_shapes_equal_jax(n):
    assert tmesh._factor2(n) == jmesh._factor2(n)
    got = tmesh.make_mesh(devices=[CPU] * 8, n_devices=n)
    want = jmesh.make_mesh(n)
    assert got.shape == dict(want.shape)
    assert got.axis_names == want.axis_names and got.size == n


def test_make_mesh_needs_a_card_unless_given_devices():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh()
    mesh = tmesh.Mesh([["cpu"], ["cpu"]])
    assert mesh.shape == {"data": 2, "space": 1}
    assert tmesh._grid(mesh) == (2, 1, [CPU, CPU])


def test_sharded_apply_equals_one_device(params):
    mesh = two_cpus()
    x = np.random.default_rng(0).random((4, 1, 2, 16, 16)).astype(
        np.float32)
    run = tmesh.sharded_apply(tmesh.replicate_params(params, mesh),
                              UNetSpec(1, 5), mesh)
    got = run(x)
    want = UNetModel(params)(x, device=CPU)
    assert got.shape == (4, 5, 2, 16, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_sharded_predict_volume_equals_jax_and_port(params, record_property):
    """Five chunks over two data devices: the last batch is zero-padded."""
    vol = np.random.default_rng(1).random((4, 48, 64)).astype(np.float32)
    grid = dict(chunk_size=(4, 32, 32), margin=(1, 8, 8))
    got = tmesh.sharded_predict_volume(UNetModel(params), vol, two_cpus(),
                                       **grid)
    want = np.asarray(jmesh.sharded_predict_volume(
        JaxModel({k: jnp.asarray(v) for k, v in params.items()}), vol,
        jax_data_mesh(), **grid))
    err = float(np.abs(got - want).max())
    record_property("max_abs_vs_jax", err)
    assert got.shape == (5, 4, 48, 64) and err <= 5e-4
    np.testing.assert_array_equal(
        got, predict_volume(UNetModel(params), vol, device=CPU,
                            batch_size=1, **grid))


def batch(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    x = r.random((2, 1, 4, 16, 16)).astype(dtype)
    y = (r.random((2, 5, 4, 16, 16)) > 0.5).astype(dtype)
    return x, y


def dp_step(params, x, y, dtype=torch.float32):
    """One data-parallel forward and backward over ``[cpu, cpu]`` (SGD at
    lr 0 leaves the weights, so the gradients and stats can be read)."""
    net = params_from_numpy(params).to(dtype).train()
    step = tmesh.make_sharded_train_step(
        two_cpus(), net, tl.make_loss_function("BCELoss"),
        torch.optim.SGD(net.parameters(), lr=0.0), double_step=False)
    loss = step(torch.from_numpy(x), torch.from_numpy(y), 0)
    return float(loss), net


def one_device_step(params, x, y, dtype=torch.float32):
    net = params_from_numpy(params).to(dtype).train()
    loss = tl.make_loss_function("BCELoss")(
        net(torch.from_numpy(x)), torch.from_numpy(y), 0)
    loss.backward()
    return float(loss.detach()), net


def grad_resid(a, b):
    """(largest gradient difference, largest gradient of ``a``)."""
    ga, gb = dict(a.named_parameters()), dict(b.named_parameters())
    assert set(ga) == set(gb)
    gmax = max(float(p.grad.abs().max()) for p in ga.values())
    return max(float((ga[k].grad - gb[k].grad).abs().max())
               for k in ga), gmax


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dp_step_equals_batch2_step_and_jax(params, seed, record_property):
    x, y = batch(seed)
    loss, dp = dp_step(params, x, y)
    want, one = one_device_step(params, x, y)
    assert abs(loss - want) <= 1e-6 * abs(want)
    worst, gmax = grad_resid(one, dp)
    record_property("grad_resid_rel_vs_batch2", worst / gmax)
    assert worst <= 1e-6 * gmax
    sd_dp, sd_one = dp.state_dict(), one.state_dict()
    stats = [k for k in sd_one if "running" in k]
    assert len(stats) == 9 * 2 * 2
    for k in stats:
        np.testing.assert_allclose(sd_dp[k].numpy(), sd_one[k].numpy(),
                                   rtol=0, atol=1e-6)
        assert int(sd_dp[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 1
    # JAX's global-batch gradient of the same loss
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    trainable, bn_state = jax_train._split_params(jp)

    def loss_wrapped(tr):
        out, upd = jax_forward({**tr, **bn_state}, JaxSpec(1, 5), x,
                               train=True)
        return jl.bce_loss(out, jnp.asarray(y)), upd

    (jloss, jupd), jgrads = jax.value_and_grad(
        loss_wrapped, has_aux=True)(trainable)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = dict(dp.named_parameters())
    jmax = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    jworst = max(float(np.abs(grads[k].grad.numpy() - np.asarray(g)).max())
                 for k, g in jgrads.items())
    record_property("grad_resid_rel_vs_jax", jworst / jmax)
    assert jworst <= 1e-5 * jmax
    for k, v in jupd.items():
        v = np.asarray(v)
        assert np.abs(sd_dp[k].numpy() - v).max() <= 1e-5 * np.abs(v).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dp_step_equals_batch2_step_in_float64(params, seed):
    x, y = batch(seed, np.float64)
    loss, dp = dp_step(params, x, y, torch.float64)
    want, one = one_device_step(params, x, y, torch.float64)
    assert abs(loss - want) <= 1e-12 * abs(want)
    worst, gmax = grad_resid(one, dp)
    assert worst <= 1e-12 * gmax


def test_dp_step_double_adam_moves_the_master(params):
    """Two Adam steps on the reduced gradients, on the master module."""
    x, y = batch(3)
    net = params_from_numpy(params).train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    step = tmesh.make_sharded_train_step(
        two_cpus(), net, tl.make_loss_function("BCELoss"),
        torch.optim.Adam(net.parameters(), lr=0.01), double_step=True,
        chan_log_fn=tl.make_loss_function("BCELoss"), n_channels=5)
    loss, chan = step(x, y, 0)
    assert torch.isfinite(loss) and chan.shape == (5,)
    moved = net.state_dict()["c0.conv0.weight"] - before["c0.conv0.weight"]
    # Adam's first two steps on one gradient move each weight by ~2 lr
    assert 0.015 < float(moved.abs().max()) <= 0.0201


def test_train_unet_mesh_matches_jax(params, tmp_path, record_property):
    """``__graft_entry__.dryrun_multichip``'s drive: 2·dp+1 chunks, two
    full steps and a repeat-padded tail, on a (2, 1) mesh."""
    r = np.random.default_rng(0)
    shape = (2, 16, 16)
    x = [r.random(shape, dtype=np.float32) for _ in range(5)]
    y = [(r.random((5,) + shape) > 0.5).astype(np.float32)
         for _ in range(5)]
    kw = dict(epochs=1, lr=0.01, channels=CHANNELS, update_every=1,
              weights=params, validate=True)
    torch_train.train_unet(x, x[:1], y, y[:1], out_dir=str(tmp_path / "t"),
                           mesh=two_cpus(), **kw)
    jax_train.train_unet(x, x[:1], y, y[:1], out_dir=str(tmp_path / "j"),
                         mesh=jax_data_mesh(), **kw)
    import pandas as pd

    got = pd.read_csv(tmp_path / "t" / "loss_my-unet.csv")
    want = pd.read_csv(tmp_path / "j" / "loss_my-unet.csv")
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) == 3
    assert list(got["data_id"]) == list(want["data_id"]) == [
        "my-unet_0;my-unet_1", "my-unet_2;my-unet_3", "my-unet_4"]
    assert list(got["batch_num"]) == [0, 1, 2]
    rel = float(abs(got["loss"][0] - want["loss"][0])
                / abs(want["loss"][0]))
    record_property("first_loss_rel", rel)
    assert rel <= 1e-5
    gv = pd.read_csv(tmp_path / "t" / "validation-loss_my-unet.csv")
    jv = pd.read_csv(tmp_path / "j" / "validation-loss_my-unet.csv")
    assert list(gv.columns) == list(jv.columns)
    assert list(gv["batch_id"]) == list(jv["batch_id"]) == [0, 3]


def test_train_unet_n_devices_builds_the_mesh(monkeypatch):
    """``n_devices`` is ``make_mesh(n_devices)`` over the cards, as in JAX:
    with no card it raises and never falls back to the CPU. Over three
    listed devices (a (3, 1) mesh) one step takes a 3-chunk batch."""
    r = np.random.default_rng(4)
    x = [r.random((2, 16, 16), dtype=np.float32) for _ in range(3)]
    y = [(r.random((2, 2, 16, 16)) > 0.5).astype(np.float32)
         for _ in range(3)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_train.train_unet(x, [], y, [], epochs=1, validate=False,
                                   n_devices=3)
    built = []
    make_mesh = tmesh.make_mesh

    def on_three_cpus(n_devices=None):
        built.append(n_devices)
        return make_mesh(n_devices, devices=[CPU] * 3)

    monkeypatch.setattr(tmesh, "make_mesh", on_three_cpus)
    prof = {}
    model, path = torch_train.train_unet(
        x, [], y, [], epochs=1, validate=False, n_devices=3, profile=prof)
    assert built == [3]
    assert path is None and len(prof["step_s"]) == 1
    out = model(np.zeros((1, 1, 2, 16, 16), np.float32), device=CPU)
    assert out.shape == (1, 2, 2, 16, 16) and torch.isfinite(out).all()
