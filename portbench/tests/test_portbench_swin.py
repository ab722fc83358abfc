"""The Swin UNETR cell's files on the CPU, at a tiny size: the driver reads
every key and holds the configuration to its weights, it runs and checks
a call, the FLOP count equals ``torch.utils.flop_counter``'s, and both
metric readers read a made-up run."""
import copy
import json
import os

import pytest
import torch

from conftest import PORTBENCH

CELL = "swin.stack"
# feature size 12 (the cell's is 48): 4,078,103 learnt values
TINY = {"feature_size": 12, "learnt_parameters": 4078103,
        "frame": [32, 64, 96], "assumed": {"blobs_per_frame": 12,
                                           "peak": 50000, "noise": 500},
        "segment": {"segmenter": "affinity-unet-watershed",
                    "chunk": [32, 64, 64], "margin": [4, 8, 8],
                    "flood": "host"}}
TINY_MIX = {"driver": "segment_swin", "devices": 1, "frames_per_call": 2,
            "distinct_calls": 1, "pool": 2, "checked_frames": 2, "tail": 1}


@pytest.fixture
def tiny_files(tmp_path):
    """The cell's configuration and mix cut to ``TINY``, as files in a
    temporary directory."""
    from harness import bench

    _, _, cfg, mix, limits = bench.load_cell(CELL)
    assert mix["driver"] == "segment_swin"
    cfg = dict(cfg, **TINY)
    paths = {}
    for name, data in (("config", cfg), ("mix", TINY_MIX)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(data))
    return paths, limits


def _context(paths, seed=2**31 + 5, **cfg_kw):
    from harness import bench

    cfg = dict(json.loads(paths["config"].read_text()), **cfg_kw)
    mix = json.loads(paths["mix"].read_text())
    return bench.Context(CELL, cfg, mix, seed, [torch.device("cpu")])


def test_the_driver_reads_every_key(tiny_files):
    from harness import bench

    paths, _ = tiny_files
    d = bench.make_driver(_context(paths))
    assert os.path.exists(d.ckpt)
    with pytest.raises(ValueError, match="colour"):
        bench.make_driver(_context(paths, colour="blue"))


def test_a_later_run_loads_the_seeded_checkpoint(tiny_files, monkeypatch,
                                                 tmp_path):
    """Set-up draws and writes the weights once a checkout: a second
    driver with the same seed and widths loads the file (the draw is not
    called again), and another seed gets a file of its own."""
    from drivers import segment_swin
    from harness import bench

    monkeypatch.setattr(bench, "CHECKOUT", str(tmp_path / "checkout"))
    paths, _ = tiny_files
    first = bench.make_driver(_context(paths))
    drawn = []
    real = segment_swin.ref_swin.init_params
    monkeypatch.setattr(segment_swin.ref_swin, "init_params",
                        lambda *a, **k: drawn.append(a) or real(*a, **k))
    again = bench.make_driver(_context(paths))
    assert drawn == [] and again.ckpt == first.ckpt
    assert all(torch.equal(first.params[k], v)
               for k, v in again.params.items())
    other = bench.make_driver(_context(paths, weights_seed=1))
    assert drawn == [(1,)] and other.ckpt != first.ckpt
    assert os.path.exists(other.ckpt)


@pytest.mark.parametrize("key,value,named", [
    ("learnt_parameters", 4078104, "learnt_parameters"),
    # the weights are drawn with the stated heads: their count tells
    ("num_heads", [3, 6, 12, 12], "learnt_parameters"),
    ("window_size", 8, "window_size"), ("mlp_ratio", 2, "mlp_ratio"),
    ("norm", "batch", "norm"), ("downsample", "mergingv2", "downsample"),
    ("tf32", True, "tf32")])
def test_a_configuration_other_than_its_weights_is_refused(tiny_files, key,
                                                           value, named):
    from harness import bench

    paths, _ = tiny_files
    with pytest.raises(ValueError, match=named):
        bench.make_driver(_context(paths, **{key: value}))


def test_a_tiny_run_is_correct_and_its_control_is_not(tiny_files):
    """One call of the window, its check against the reference, and the
    control: the reference in the precision below is the same on the CPU
    (no TF32 there), so both read 0 here; the card's readings are in
    PERF.md."""
    from harness import bench

    paths, limits = tiny_files
    d = bench.make_driver(_context(paths))
    d.warm()
    run = d.window(0.0)
    assert all(c[3] for c in run["calls"])
    d.release()
    checks = d.check()
    assert set(checks) == set(limits) == {"label_mismatch", "feature_gap"}
    assert checks["label_mismatch"] == 0.0
    assert checks["feature_gap"] <= 1e-5
    assert bench.judge(checks, limits, 0)[0]


@pytest.mark.parametrize("feature_size,zyx", [(12, (32, 64, 64)),
                                              (12, (64, 32, 96)),
                                              (48, (96, 96, 96))])
def test_flop_count_equals_the_flop_counter(feature_size, zyx):
    from torch.utils.flop_counter import FlopCounterMode

    from counts.swin_unetr_flops import forward_flops
    from reference import swin_unetr as ref

    p = {k: v.to("meta") for k, v in ref.init_params(
        0, feature_size=feature_size).items()}
    with FlopCounterMode(display=False) as counter:
        ref.forward(p, torch.zeros((1, 1) + zyx, device="meta"))
    assert forward_flops(zyx, feature_size=feature_size) == \
        counter.get_total_flops()


def test_the_cells_chunk_count():
    from counts import window_attention as wa
    from counts.swin_unetr_flops import forward_flops

    # the counts PERF.md states: 636.3 GFLOP a 96^3 chunk, and per chunk
    # 2 x (343 x 3 + 64 x 6 + 8 x 12 + 1 x 24) window-heads
    assert forward_flops((96, 96, 96)) == 636_285_053_568
    geometry = dict(feature_size=48, num_heads=(3, 6, 12, 24),
                    depths=(2, 2, 2, 2))
    assert wa.windows_heads((96, 96, 96), **geometry) == 3066
    assert sum(wa.flops(*launch) for launch in wa.launches(
        (96, 96, 96), **geometry)) == 22_867_466_880


def _made_up_run(counter_value, frames=2, kernel_s=0.02):
    from harness import bench
    from harness.keys import Keys

    _, _, cfg, mix, _ = bench.load_cell(CELL)
    voxels = 96 * 512 * 512
    items = [{"kind": "span", "name": "call", "id": 1, "call": 1}]
    items += [{"kind": "span", "name": "frame", "id": 2 + i, "call": 1}
              for i in range(frames)]
    items.append({"kind": "counter", "name": "window_attention_windows",
                  "value": counter_value, "call": 1})
    run = {"kind": "segment", "window_s": 10.0, "chips": 1,
           "cfg": Keys(cfg), "mix": Keys(mix),
           "calls": [(0.0, 5.0, 2 * voxels, True),
                     (5.0, 10.0, 2 * voxels, True)],
           "trace": {"busy_s": 1.0, "window_s": 1.0, "device_ops": [],
                     "idle_gaps": [], "window_attention_s": kernel_s}}
    return run, items


def test_the_metric_readers(monkeypatch):
    from harness import bench
    from iterseg_tpu_torch import utils

    full = 2 * 49 * 3066
    run, items = _made_up_run(full)
    monkeypatch.setattr(utils, "spans", lambda: copy.deepcopy(items))
    # 4 frames of 49 chunks at 636.3 GFLOP in 10 s on 67 TFLOP/s
    assert bench.reader("mfu.swin")(run) == pytest.approx(
        100 * 4 * 49 * 636_285_053_568 / (10 * 67e12))
    roof = bench.reader("window_attention_roofline.swin")
    # 2 frames x 49 chunks of 22.87 GFLOP, bound by the float32 peak
    assert roof(run) == pytest.approx(
        100 * 98 * 22_867_466_880 / 67e12 / 0.02, rel=1e-3)
    short, items_short = _made_up_run(full - 3)
    monkeypatch.setattr(utils, "spans", lambda: copy.deepcopy(items_short))
    assert roof(short) is None
    # the U-Net's runs, and a run without the kernel's seconds, read None
    run["trace"]["window_attention_s"] = 0.0
    assert roof(run) is None


def test_the_readers_skip_the_unet_configuration():
    from harness import bench
    from harness.keys import Keys

    _, _, cfg, _, _ = bench.load_cell("unet.stack")
    run = {"kind": "segment", "cfg": Keys(cfg), "calls": [], "chips": 1,
           "window_s": 1.0, "trace": {"window_attention_s": 1.0}}
    for name in ("mfu.swin", "window_attention_roofline.swin"):
        assert bench.reader(name)(run) is None


def test_the_cell_is_in_the_benchmark():
    with open(os.path.join(os.path.dirname(PORTBENCH),
                           "BENCHMARK.json")) as f:
        spec = json.load(f)
    work = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert work["chips"] == 1 and work["config"] == "swin-unetr"
    conf = next(c for c in spec["configs"] if c["name"] == "swin-unetr")
    assert conf["reduced"] == []


def test_the_swin_reference_loads_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = [%r]; import reference.swin_unetr; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            % PORTBENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(out.stdout.split())
    assert "reference" in mods
    assert not mods & {"jax", "jaxlib", "flax", "iterseg_tpu",
                       "iterseg_tpu_torch", "harness"}
