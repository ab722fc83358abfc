"""The port's ``space`` mesh axis (``iterseg_tpu_torch.parallel.mesh`` over
``models.unet.XSplit``) against the port's one-device forward and step and
against the JAX package's mesh, on the CPU.

torch has one CPU device, so a port mesh lists it once a block (``[cpu] *
4`` is a (1, 4) mesh): every halo fetch, split, gather and reduction runs
as it does over four cards. JAX's side runs on conftest's virtual CPU
devices, ``make_mesh(n)``'s shapes. Chunks are (z, y, x) = (2, 16, 16·S)
of the full-width ``UNetSpec(1, 5)``, as in ``tests/test_parallel.py``.

- ``sharded_apply`` and ``sharded_predict_volume`` on (1, 2), (1, 4),
  (2, 2) and (2, 4) meshes: within 1e-6 max-abs of the port's one-device
  forward and 5e-4 of JAX's (readings recorded as properties); x = 32 on
  (1, 4) leaves one block without a plane at the deepest level.
- Each block owns the balanced split of every level's width: W / S at
  level 0, and at the deepest level the split of 17, 5 or 3 planes.
- The train step on (1, 2) and (2, 2), seeds 0-2: loss and running
  statistics within 1e-6 of the port's one-device step on the same global
  batch; gradients held against the float64 one-device step, no further
  from it than the float32 one-device step (+1e-6 of the largest) and
  JAX's global-batch ``jax.grad`` (+1e-5); a float64 witness at 1e-12.
- ``train_unet(mesh=make_mesh(devices=[cpu, cpu]))`` against the batch-1
  loop, and ``make_mesh(devices=[cpu] * n)`` for n in 1..8 through all five
  mesh functions, where JAX's ``make_mesh(n)`` runs ``sharded_apply``.
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
from iterseg_tpu_torch.helpers import read_csv
from iterseg_tpu_torch.models.convert import params_from_numpy
from iterseg_tpu_torch.models.unet import UNet, UNetSpec, XSplit, each_shard
from iterseg_tpu_torch.parallel import mesh as tmesh
from iterseg_tpu_torch.train import losses as tl
from iterseg_tpu_torch.train import train as torch_train
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
MESHES = [(1, 2), (1, 4), (2, 2), (2, 4)]
GRID = dict(chunk_size=(4, 32, 32), margin=(1, 8, 8))


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v) for k, v in
            init_params(JaxSpec(1, 5), seed=0).items()}


def cpu_mesh(dp, sp):
    return tmesh.Mesh([[CPU] * sp] * dp, ("data", "space"))


def jax_mesh(dp, sp):
    return jax.sharding.Mesh(
        np.array(jax.devices()[:dp * sp]).reshape(dp, sp), ("data", "space"))


def jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("dp,sp,width", [(1, 2, 32), (1, 4, 64), (2, 2, 32),
                                         (2, 4, 64), (1, 4, 32)])
def test_sharded_apply_equals_one_device_and_jax(params, dp, sp, width,
                                                 record_property):
    x = np.random.default_rng(10 * dp + sp).random(
        (dp, 1, 2, 16, width)).astype(np.float32)
    mesh = cpu_mesh(dp, sp)
    got = tmesh.sharded_apply(tmesh.replicate_params(params, mesh),
                              UNetSpec(1, 5), mesh)(x)
    assert got.shape == (dp, 5, 2, 16, width) and got.device == CPU
    one = float((got - UNetModel(params)(x, device=CPU)).abs().max())
    jm = jax_mesh(dp, sp)
    want = np.asarray(jmesh.sharded_apply(
        jmesh.replicate_params(jax_params(params), jm), JaxSpec(1, 5), jm)(x))
    vs_jax = float(np.abs(got.numpy() - want).max())
    record_property("max_abs_vs_one_device", one)
    record_property("max_abs_vs_jax", vs_jax)
    assert one <= 1e-6 and vs_jax <= 5e-4


@pytest.mark.parametrize("dp,sp", MESHES)
def test_sharded_predict_volume_equals_port_and_jax(params, dp, sp,
                                                    record_property):
    """Six (4, 32, 32) chunks, x split over ``space``; the last batch of a
    (2, S) mesh is zero-padded."""
    vol = np.random.default_rng(1).random((4, 48, 64)).astype(np.float32)
    got = tmesh.sharded_predict_volume(UNetModel(params), vol,
                                       cpu_mesh(dp, sp), **GRID)
    one = float(np.abs(got - predict_volume(
        UNetModel(params), vol, device=CPU, batch_size=1, **GRID)).max())
    want = np.asarray(jmesh.sharded_predict_volume(
        JaxModel(jax_params(params)), vol, jax_mesh(dp, sp), **GRID))
    vs_jax = float(np.abs(got - want).max())
    record_property("max_abs_vs_one_device", one)
    record_property("max_abs_vs_jax", vs_jax)
    assert got.shape == (5, 4, 48, 64) and one <= 1e-6 and vs_jax <= 5e-4


@pytest.mark.parametrize("sp,width,deepest", [
    (2, 32, [1, 2]), (4, 64, [1, 1, 1, 2]), (4, 32, [0, 1, 1, 1]),
    (4, 256, [4, 4, 4, 5])])
def test_each_shard_owns_its_balanced_share(sp, width, deepest):
    """The planes each block's BatchNorms see: W / S at level 0, the
    balanced split of the deepest level's width (17, 5 or 3) there; an
    empty block still takes part and comes out empty."""
    net = UNet(UNetSpec(1, 5)).init_weights(0)
    seen = {}

    def layer(m, xs, **kw):
        seen.setdefault(m, [x.shape[-1] for x in xs])
        return each_shard(m, xs, **kw)

    xs = list(torch.rand(1, 1, 2, 16, width).chunk(sp, -1))
    with torch.no_grad():
        outs = net.forward_shards(xs, layer, XSplit(sp))
    assert seen[net.c0.batch0] == seen[net.c8_0.batch1] == [width // sp] * sp
    assert seen[net.c4.batch0] == seen[net.c4.batch1] == deepest
    assert [o.shape[-1] for o in outs] == [width // sp] * sp


def test_a_row_off_its_balanced_split_raises():
    """A block holding more than its share (a chunk gathered whole) is
    refused, never run."""
    net = UNet(UNetSpec(1, 5))
    x = torch.rand(1, 1, 2, 16, 32)
    with pytest.raises(RuntimeError, match="balanced split"):
        net.forward_shards([x[..., :24], x[..., 24:]], split=XSplit(2))


@pytest.mark.parametrize("dp,sp", MESHES)
def test_data_sharding_blocks_rejoin_to_the_input(dp, sp):
    x = torch.arange(2 * dp * 3 * 4 * sp, dtype=torch.float32).reshape(
        2 * dp, 1, 1, 3, 4 * sp)
    blocks = tmesh.data_sharding(cpu_mesh(dp, sp))(x)
    assert len(blocks) == dp * sp
    assert all(b.shape == (2, 1, 1, 3, 4) for b in blocks)
    rows = [torch.cat(blocks[r:r + sp], -1) for r in range(0, dp * sp, sp)]
    torch.testing.assert_close(torch.cat(rows), x, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 1, 2, 16, 18), (3, 1, 2, 16, 32)])
def test_data_sharding_refuses_what_does_not_divide(shape):
    """x = 18 over four ``space`` devices, as JAX's ``device_put``
    refuses; N = 3 over two ``data`` rows."""
    mesh = tmesh.make_mesh(devices=[CPU] * (4 if shape[-1] == 18 else 8))
    with pytest.raises(ValueError, match="does not split"):
        tmesh.data_sharding(mesh)(np.zeros(shape, np.float32))


def batch(seed, dp, sp, dtype=np.float32):
    r = np.random.default_rng(seed)
    x = r.random((dp, 1, 2, 16, 16 * sp)).astype(dtype)
    y = (r.random((dp, 5, 2, 16, 16 * sp)) > 0.5).astype(dtype)
    return x, y


def mesh_step(params, x, y, mesh, dtype=torch.float32):
    """One step over ``mesh`` (SGD at lr 0 leaves the weights, so the
    gradients and stats can be read)."""
    net = params_from_numpy(params).to(dtype).train()
    step = tmesh.make_sharded_train_step(
        mesh, net, tl.make_loss_function("BCELoss"),
        torch.optim.SGD(net.parameters(), lr=0.0), double_step=False)
    return float(step(torch.from_numpy(x), torch.from_numpy(y), 0)), net


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


def grads_of(net):
    return {k: p.grad.double().numpy() for k, p in net.named_parameters()}


def max_err(grads, truth):
    return max(float(np.abs(grads[k] - truth[k]).max()) for k in truth)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2)])
def test_space_step_equals_one_device_step_and_jax(params, dp, sp, seed,
                                                   record_property):
    """Loss and running statistics against the one-device step (1e-6).
    Gradients against the float64 one-device step, the truth (the float64
    witness below holds the space step to it at 1e-12): the space step's
    float32 error exceeds the one-device step's by at most 1e-6 of the
    largest gradient, and JAX's float32 ``jax.grad``'s by at most 1e-5.
    The float32 steps are not held to each other directly: at this size a
    BatchNorm channel of nearly constant activations amplifies a last-bit
    difference of summation order, so the float32 one-device step itself
    reads up to 9.6e-4 of the largest gradient off the truth (seed 0, the
    same for the space step) or 1.8e-5 (seed 2, where the space step
    reads 3.8e-7), depending on the torch thread count."""
    x, y = batch(seed, dp, sp)
    loss, got = mesh_step(params, x, y, cpu_mesh(dp, sp))
    want, one = one_device_step(params, x, y)
    assert abs(loss - want) <= 1e-6 * abs(want)
    _, one64 = one_device_step(params, x.astype(np.float64),
                               y.astype(np.float64), torch.float64)
    truth = grads_of(one64)
    gmax = max(float(np.abs(g).max()) for g in truth.values())
    err, err_one = max_err(grads_of(got), truth), max_err(grads_of(one),
                                                          truth)
    record_property("grad_err_rel", err / gmax)
    record_property("grad_err_rel_one_device", err_one / gmax)
    record_property("grad_resid_rel_vs_one_device",
                    max_err(grads_of(got), grads_of(one)) / gmax)
    assert err <= err_one + 1e-6 * gmax
    sd, sd_one = got.state_dict(), one.state_dict()
    stats = [k for k in sd_one if "running" in k]
    assert len(stats) == 9 * 2 * 2
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), sd_one[k].numpy(),
                                   rtol=0, atol=1e-6)
    trainable, bn_state = jax_train._split_params(jax_params(params))

    def loss_wrapped(tr):
        out, upd = jax_forward({**tr, **bn_state}, JaxSpec(1, 5), x,
                               train=True)
        return jl.bce_loss(out, jnp.asarray(y)), upd

    (jloss, jupd), jgrads = jax.value_and_grad(
        loss_wrapped, has_aux=True)(trainable)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    err_jax = max_err({k: np.asarray(g, np.float64)
                       for k, g in jgrads.items()}, truth)
    record_property("grad_err_rel_jax", err_jax / gmax)
    assert err <= err_jax + 1e-5 * gmax
    for k, v in jupd.items():
        v = np.asarray(v)
        assert np.abs(sd[k].numpy() - v).max() <= 1e-5 * np.abs(v).max()


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2), (1, 4)])
def test_space_step_equals_one_device_step_in_float64(params, dp, sp):
    x, y = batch(0, dp, sp, np.float64)
    loss, got = mesh_step(params, x, y, cpu_mesh(dp, sp), torch.float64)
    want, one = one_device_step(params, x, y, torch.float64)
    assert abs(loss - want) <= 1e-12 * abs(want)
    worst, gmax = grad_resid(one, got)
    assert worst <= 1e-12 * gmax


def test_train_unet_on_a_space_mesh(params, tmp_path, record_property):
    """``make_mesh`` over two devices is JAX's (1, 2) mesh: one chunk a
    step, x split in two; its first loss is the batch-1 loop's."""
    r = np.random.default_rng(5)
    x = [r.random((2, 16, 32), dtype=np.float32) for _ in range(3)]
    y = [(r.random((5, 2, 16, 32)) > 0.5).astype(np.float32)
         for _ in range(3)]
    kw = dict(epochs=1, lr=0.01, update_every=1, weights=params,
              validate=True)
    mesh = tmesh.make_mesh(devices=[CPU, CPU])
    assert mesh.shape == {"data": 1, "space": 2}
    torch_train.train_unet(x, x[:1], y, y[:1], out_dir=str(tmp_path / "m"),
                           mesh=mesh, **kw)
    torch_train.train_unet(x, x[:1], y, y[:1], out_dir=str(tmp_path / "b"),
                           device=CPU, **kw)
    got = read_csv(tmp_path / "m" / "loss_my-unet.csv")
    want = read_csv(tmp_path / "b" / "loss_my-unet.csv")
    assert list(got) == list(want) and len(got["loss"]) == 3
    assert list(got["data_id"]) == [f"my-unet_{i}" for i in range(3)]
    assert np.isfinite(got["loss"]).all()
    rel = abs(got["loss"][0] - want["loss"][0]) / abs(want["loss"][0])
    record_property("first_loss_rel", rel)
    assert rel <= 1e-5


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_of_n_cpus_runs_every_mesh_function(params, n):
    """Each mesh ``make_mesh`` builds over n listed devices runs
    ``replicate_params``, ``data_sharding``, ``sharded_apply``, the train
    step and ``sharded_predict_volume``; ``sharded_apply`` equals the
    one-device forward and JAX's ``make_mesh(n)`` result."""
    mesh = tmesh.make_mesh(devices=[CPU] * n)
    dp, sp = mesh.shape["data"], mesh.shape["space"]
    assert (dp, sp) == tmesh._factor2(n)
    x, y = batch(n, dp, sp)
    reps = tmesh.replicate_params(params, mesh)
    assert len(reps) == len(tmesh.data_sharding(mesh)(x)) == n
    got = tmesh.sharded_apply(reps, UNetSpec(1, 5), mesh)(x)
    np.testing.assert_allclose(got.numpy(), UNetModel(params)(
        x, device=CPU).numpy(), rtol=0, atol=1e-6)
    jm = jmesh.make_mesh(n)
    assert dict(jm.shape) == mesh.shape
    want = np.asarray(jmesh.sharded_apply(
        jmesh.replicate_params(jax_params(params), jm), JaxSpec(1, 5), jm)(x))
    assert np.abs(got.numpy() - want).max() <= 5e-4
    loss, _ = mesh_step(params, x, y, mesh)
    assert np.isfinite(loss)
    vol = np.random.default_rng(n).random((4, 40, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tmesh.sharded_predict_volume(UNetModel(params), vol, mesh, **GRID),
        predict_volume(UNetModel(params), vol, device=CPU, batch_size=1,
                       **GRID), rtol=0, atol=1e-6)
