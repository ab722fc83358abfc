"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
of a tiny CPU cell (``conftest.tiny``) with one fault planted in the
program: an answer altered where it is produced (the host floods merge
object 1 into object 2), half of a stack's frames left out, a train step
that leaves its state unchanged, one that leaves one leaf unchanged, a
loss over half of the batch. No cell has an exchange between cards (the
four-card stack hands each card whole frames), so no fault drops one.
"""
import pytest
import torch


def _verdict(ctx, limits):
    from harness import bench

    run, checks = bench.run_cell(ctx, 0.1, False)
    failed = sum(1 for c in run.get("calls", []) if not c[3])
    return bench.judge(checks, limits, failed)


@pytest.mark.parametrize("cell", ["unet.stack", "dog.volume"])
def test_sound_run_is_correct(cell, cpu_context):
    assert _verdict(*cpu_context(cell))[0]


@pytest.mark.parametrize("cell", ["unet.stack", "dog.volume"])
def test_altered_answer_is_not_correct(cell, cpu_context, monkeypatch):
    from iterseg_tpu_torch import native

    def merging(real):
        def flood(*args):
            out = real(*args)
            output = args[-1]
            output[output == 1] = 2
            return out
        return flood

    for name in ("priority_flood", "bucket_flood_image"):
        monkeypatch.setattr(native, name, merging(getattr(native, name)))
    ok, compared = _verdict(*cpu_context(cell))
    assert not ok and compared["label_mismatch"]["value"] > 0


def test_stack_with_half_its_frames_left_out_is_not_correct(cpu_context,
                                                           monkeypatch):
    from iterseg_tpu_torch.engine import device_pipeline as dp

    real = dp._drive_stack

    def half(stack, output_labels, *args):
        for t in real(stack, output_labels, *args):
            if t % 2:
                output_labels[t] = 0
            yield t

    monkeypatch.setattr(dp, "_drive_stack", half)
    ok, compared = _verdict(*cpu_context("unet.stack"))
    assert not ok and compared["label_mismatch"]["value"] == 1.0


def test_sound_train_run_is_correct(cpu_context):
    assert _verdict(*cpu_context("unet.train"))[0]


@pytest.mark.parametrize("mesh", [[2, 1], [1, 2]])
def test_sound_mesh_train_run_is_correct(mesh, cpu_context):
    """A mix's ``mesh`` trains over a data or space mesh (two CPU devices
    here); the reference takes the data axis's chunks as one batch. The
    mesh's BatchNorm sums in float64, so its leaves' gaps read up to
    ~3e-4 on the CPU (a mesh cell brings limits of its own): far under the
    faults' 0.2-1, and the losses agree."""
    ctx, limits = cpu_context("unet.train")
    dict.__setitem__(ctx.mix, "mesh", mesh)
    gaps = {k: v["value"] for k, v in _verdict(ctx, limits)[1].items()}
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-3 and gaps["change_gap"] < 1e-3


def test_train_step_that_keeps_its_state_is_not_correct(cpu_context,
                                                        monkeypatch):
    def step(self, closure=None):
        return None

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    ok, compared = _verdict(*cpu_context("unet.train"))
    assert not ok and compared["change_gap"]["value"] > 0.5


def test_train_step_that_drops_one_leaf_is_not_correct(cpu_context,
                                                      monkeypatch):
    """The optimizer sees a zero gradient for one decoder conv's weight
    (one leaf of 80): the worst leaf reads it."""
    real = torch.optim.Adam.step

    def step(self, closure=None):
        leaves = [p for g in self.param_groups for p in g["params"]]
        big = [p for p in leaves if p.dim() == 5 and p.grad is not None]
        big[-2].grad.zero_()
        return real(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    ok, compared = _verdict(*cpu_context("unet.train"))
    assert not ok
    assert compared["grad_gap"]["value"] > 0.5
    assert compared["change_gap"]["value"] > 0.5


def test_loss_over_half_the_batch_is_not_correct(cpu_context, monkeypatch):
    from iterseg_tpu_torch.train import train

    real = train.make_loss_function

    def halved(*args, **kw):
        fn = real(*args, **kw)

        def loss(x, y, *rest):
            w = x.shape[-1] // 2
            return fn(x[..., :w], y[..., :w], *rest)
        return loss

    monkeypatch.setattr(train, "make_loss_function", halved)
    ok, compared = _verdict(*cpu_context("unet.train"))
    assert not ok and compared["loss_gap"]["value"] > 1e-3


def test_dog_control_is_not_correct(cpu_context):
    from harness import bench

    ctx, limits = cpu_context("dog.volume")
    checks = bench.make_driver(ctx).control()
    assert not bench.judge(checks, limits, 0)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["unet.stack", "unet.train"])
def test_tf32_control_is_not_correct(cell, cuda):
    """The reference with TF32 convolutions, at the cell's chunk size."""
    from harness import bench

    _, _, cfg, mix, limits = bench.load_cell(cell)
    if mix["driver"] == "segment":
        mix = dict(mix, distinct_calls=1)
    ctx = bench.Context(cell, cfg, mix, 2**31 + 3, [cuda])
    checks = bench.make_driver(ctx).control()
    assert not bench.judge(checks, limits, 0)[0]
