"""The port's CLI (``python -m iterseg_tpu_torch``) against the JAX
package's: the same subcommands and options (plus the port's ``--device``),
DoG labels and OME metadata bit-equal to JAX's CLI run op by op, affinity
labels bit-equal to the port's own segmenter call, ``pod-segment`` over
two gloo processes equal to one process, ``convert`` through an orbax
directory, and a directory that is no orbax checkpoint exiting non-zero."""
import argparse
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from conftest import cpu_subprocess_env
from iterseg_tpu import cli as jcli
from iterseg_tpu_torch import cli as tcli
from iterseg_tpu_torch.io.zarr_io import open_zarr
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GRID = ["--chunk-size", "8,48,48", "--margin", "1,8,8"]


def blob_stack(shape=(2, 8, 48, 48), n=30, seed=0):
    r = np.random.default_rng(seed)
    frames, gts = [], []
    for _ in range(shape[0]):
        vol = np.zeros(shape[1:], np.float32)
        vol[tuple(np.stack([r.integers(2, s - 2, size=n)
                            for s in shape[1:]]))] = 1.0
        vol = ndi.gaussian_filter(vol, (1.0, 2.0, 2.0))
        vol /= vol.max()
        frames.append(vol)
        gts.append(ndi.label(vol > 0.3)[0].astype(np.int32))
    return np.stack(frames), np.stack(gts)


def save_zarr(path, data):
    arr = open_zarr(str(path), shape=data.shape,
                    chunks=(1,) + data.shape[1:], dtype=data.dtype)
    arr[...] = data
    return str(path)


@pytest.fixture(scope="module")
def stack_zarrs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli-data")
    image, gt = blob_stack()
    return save_zarr(d / "images.zarr", image), save_zarr(d / "gt.zarr", gt), \
        image


def parser_surface(parser):
    """Every subcommand with its options: strings, dest, default, choices,
    required, nargs, const, type and action kind (help text aside)."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[name] = parser_surface(sub)
        elif action.dest != "help":
            out[tuple(action.option_strings) or action.dest] = (
                action.dest, action.default, action.choices, action.required,
                action.nargs, action.const,
                getattr(action.type, "__name__", action.type),
                type(action).__name__)
    return out


def test_parser_equals_jax_apart_from_device():
    got = parser_surface(tcli.build_parser())
    want = parser_surface(jcli.build_parser())
    assert got.pop(("--device",))[:2] == ("device", None)
    assert got == want
    assert sorted(k for k in got if isinstance(got[k], dict)) == sorted(
        ["segment", "train", "assess", "pod-segment", "serve", "convert",
         "info"])
    args = tcli.build_parser().parse_args(
        ["--device", "cpu", "segment", "--input", "a", "--output-dir", "b",
         "--chunk-size", "8,64,64", "--scale", "4,1,1"])
    assert (args.device, args.chunk_size, args.scale) == (
        "cpu", (8, 64, 64), (4.0, 1.0, 1.0))
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["segment", "--input", "a",
                                        "--output-dir", "b",
                                        "--chunk-size", "8,64"])


def read_ome(path):
    with open(os.path.join(path, ".zattrs")) as f:
        attrs = json.load(f)
    return attrs, np.asarray(open_zarr(os.path.join(path, "0")))


def test_segment_dog_equals_jax_cli(stack_zarrs, tmp_path, capsys):
    ip, _, image = stack_zarrs
    argv = ["segment", "--input", ip, "--output-dir", None, "--name", "dog",
            "--segmenter", "DoG-blob-watershed", "--scale", "4,1,1"] + GRID
    argv[4] = str(tmp_path / "t")
    assert tcli.main(["--device", "cpu"] + argv) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed == str(tmp_path / "t" / "dog.ome.zarr")
    argv[4] = str(tmp_path / "j")
    with jax.disable_jit():
        assert jcli.main(argv) == 0
    t_attrs, t_labels = read_ome(str(tmp_path / "t" / "dog.ome.zarr"))
    j_attrs, j_labels = read_ome(str(tmp_path / "j" / "dog.ome.zarr"))
    assert t_labels.shape == image.shape and t_labels.max() > 0
    np.testing.assert_array_equal(t_labels, j_labels)
    assert t_attrs == j_attrs


@pytest.mark.parametrize("flood", [None, "pallas"])
def test_segment_affinity_equals_direct_call(stack_zarrs, tmp_path, flood):
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed

    ip, _, image = stack_zarrs
    extra = [] if flood is None else ["--device-flood", flood]
    assert tcli.main(["--device", "cpu", "segment", "--input", ip,
                      "--output-dir", str(tmp_path), "--name", "aff"]
                     + GRID + extra) == 0
    _, got = read_ome(str(tmp_path / "aff.ome.zarr"))
    want = affinity_unet_watershed(None, image, None, "x", None,
                                   chunk_size=(8, 48, 48), margin=(1, 8, 8),
                                   debug=True, devices=[CPU],
                                   device_flood=flood)
    assert got.max() > 0
    np.testing.assert_array_equal(got, want)


def test_assess_csvs_equal_jax_cli(stack_zarrs, tmp_path, capsys):
    _, gp, _ = stack_zarrs
    seg = np.asarray(open_zarr(gp))
    seg = ndi.label(ndi.binary_erosion(seg > 0, iterations=1))[0]
    sp = save_zarr(tmp_path / "seg.zarr", seg.astype(np.int32))
    for pkg, mod in (("t", tcli), ("j", jcli)):
        assert mod.main([
            "assess", "--ground-truth", gp, "--segmentation", sp,
            "--output-dir", str(tmp_path / pkg), "--prefix", "cli",
            "--name", "m", "--chunk-size", "6,24,24", "--margin", "1,4,4",
            "--exclude-chunks-less-than", "1"]) == 0
        printed = capsys.readouterr().out.strip().splitlines()[-1]
        assert printed == str(tmp_path / pkg / "cli_m_scores.csv")
    for f in ("scores", "stats", "AP_curve"):
        name = f"cli_m_{f}.csv"
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes(), name
    assert (tmp_path / "t" / "cli_m_VI_plot.pdf").exists()


def test_train_tiny(stack_zarrs, tmp_path, capsys):
    ip, gp, _ = stack_zarrs
    assert tcli.main([
        "--device", "cpu", "train", "--images", ip, "--labels", gp,
        "--output-dir", str(tmp_path), "--training-name", "cli-unet",
        "--epochs", "1", "--n-each", "2", "--validation-prop", "0.5",
        "--train-shape", "8,32,32", "--no-predict"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed.endswith(".npz") and os.path.exists(printed)
    metas = [f for f in os.listdir(tmp_path) if f.endswith("_meta.json")]
    assert len(metas) == 1


def test_convert_roundtrip(tmp_path, capsys):
    from iterseg_tpu_torch.models.convert import load_checkpoint
    from iterseg_tpu_torch.engine.predict import DEFAULT_UNET_PATH

    prev = DEFAULT_UNET_PATH
    for out in (str(tmp_path / "a.pt"), str(tmp_path / "orbax-dir"),
                str(tmp_path / "back.npz")):
        assert tcli.main(["convert", "--input", prev, "--output", out]) == 0
        assert capsys.readouterr().out.strip().splitlines()[-1] == out
        prev = out
    assert (tmp_path / "orbax-dir" / "_METADATA").exists()
    final, orig = load_checkpoint(prev), load_checkpoint(DEFAULT_UNET_PATH)
    assert set(final) == set(orig)
    for k in orig:
        np.testing.assert_array_equal(final[k], orig[k])


def test_info(capsys):
    assert tcli.main(["info"]) == 0
    out = capsys.readouterr().out
    for word in ("package: iterseg_tpu_torch", "torch: ", "cuda: ",
                 "affinity-unet-watershed", "DoG-blob-watershed",
                 "default unet:"):
        assert word in out
    if not torch.cuda.is_available():
        assert "devices: no CUDA device" in out


def test_segment_unknown_segmenter(tmp_path, capsys):
    rc = tcli.main(["--device", "cpu", "segment", "--input", "x",
                    "--output-dir", str(tmp_path), "--segmenter", "nope"])
    assert rc == 2
    assert "registered" in capsys.readouterr().err


@pytest.mark.parametrize("argv,error", [
    pytest.param(["convert", "--input", "plain-dir", "--output", "b.npz"],
                 ValueError, id="orbax-ValueError"),
    pytest.param(["--device", "cpu", "segment", "--device-flood", "exact"],
                 None, id="flood-exact"),
    pytest.param(["--device", "cpu", "segment", "--device-flood", "auto"],
                 None, id="flood-auto"),
    pytest.param(["--device", "cpu", "segment", "--flood-telemetry"],
                 None, id="flood-telemetry"),
])
def test_unported_paths_raise(stack_zarrs, tmp_path, argv, error):
    """A directory that holds no orbax checkpoint, given as ``convert
    --input``, raises naming orbax and writes nothing. The flood options
    run: ``exact`` and ``--flood-telemetry`` give the default flood's
    labels, ``auto`` on the CPU is the ``"xla"`` flood (``True``)."""
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed

    if error is not None:
        os.makedirs(tmp_path / "plain-dir")
        with pytest.raises(error, match="orbax"):
            tcli.main([str(tmp_path / a) if a.endswith(("-dir", ".npz"))
                       else a for a in argv])
        assert not (tmp_path / "b.npz").exists()
        return
    ip, _, image = stack_zarrs
    assert tcli.main(argv + ["--input", ip, "--output-dir", str(tmp_path),
                             "--name", "m"] + GRID) == 0
    _, got = read_ome(str(tmp_path / "m.ome.zarr"))
    flood = {"exact": False, "auto": True}.get(argv[-1], False)
    want = affinity_unet_watershed(None, image, None, "x", None,
                                   chunk_size=(8, 48, 48), margin=(1, 8, 8),
                                   debug=True, devices=[CPU],
                                   device_flood=flood)
    assert got.max() > 0
    np.testing.assert_array_equal(got, want)


def test_serve_local_devices_raises(stack_zarrs, tmp_path, monkeypatch):
    """``serve --local-devices`` raises without a card (never a silent CPU
    run); with two cards (stood in for by two CPU entries) the frames
    round-robin over them and the labels are one device's."""
    from iterseg_tpu_torch.engine.segmentation import dog_blob_watershed

    ip, _, image = stack_zarrs
    w = tmp_path / "in"
    os.makedirs(w)
    save_zarr(w / "stack.zarr", image)
    argv = ["serve", "--watch-dir", str(w), "--output-dir",
            str(tmp_path / "out"), "--local-devices", "--once",
            "--segmenter", "DoG-blob-watershed"] + GRID
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(argv)
    monkeypatch.setattr(tcli, "_local_devices", lambda: [CPU, CPU])
    assert tcli.main(argv) == 0
    got = np.asarray(open_zarr(str(tmp_path / "out" / "stack.ome.zarr"
                                   / "0")))
    want = dog_blob_watershed(None, image, None, "x", None, debug=True,
                              devices=[CPU])
    assert got.max() > 0
    np.testing.assert_array_equal(got, np.asarray(want))


def test_python_m_exits_non_zero_on_unported_path(tmp_path):
    """``convert`` from a directory that is no orbax checkpoint."""
    os.makedirs(tmp_path / "plain-dir")
    r = subprocess.run(
        [sys.executable, "-m", "iterseg_tpu_torch", "convert",
         "--input", str(tmp_path / "plain-dir"),
         "--output", str(tmp_path / "b.npz")],
        cwd=ROOT, env=cpu_subprocess_env(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0
    assert "ValueError" in r.stderr and "orbax" in r.stderr


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_pod_segment_two_processes_equal_one(stack_zarrs, tmp_path):
    """Two ``pod-segment --device cpu`` processes joined by gloo give the
    labels of one process, and with ``--gt`` the same CSV bytes."""
    ip, gp, _ = stack_zarrs
    common = ["--input", ip, "--gt", gp, "--segmenter",
              "DoG-blob-watershed", "--exclude-chunks-less-than", "2"] + GRID
    one = ["--device", "cpu", "pod-segment", "--output",
           str(tmp_path / "one.zarr"), "--metrics-dir",
           str(tmp_path / "m1")] + common
    assert tcli.main(one) == 0
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "iterseg_tpu_torch", "--device", "cpu",
         "pod-segment", "--output", str(tmp_path / "pod.zarr"),
         "--metrics-dir", str(tmp_path / "m2"), "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(pid)] + common, cwd=ROOT, env=cpu_subprocess_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"host frames: [{pid}]" in out
    want = np.asarray(open_zarr(str(tmp_path / "one.zarr")))
    assert want.max() > 0
    np.testing.assert_array_equal(
        np.asarray(open_zarr(str(tmp_path / "pod.zarr"))), want)
    names = sorted(os.listdir(tmp_path / "m1"))
    assert "pod-metrics_pod_scores.csv" in names
    assert sorted(os.listdir(tmp_path / "m2")) == names
    for name in names:
        assert (tmp_path / "m2" / name).read_bytes() == (
            tmp_path / "m1" / name).read_bytes(), name


def test_pod_devices_one_card_a_process(monkeypatch):
    """Without ``--device`` process p takes ``cuda:{p % device_count}``;
    ``--device`` and ``--local-devices`` override it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = tcli.build_parser().parse_args(
        ["pod-segment", "--input", "a", "--output", "b"])
    assert [tcli._pod_devices(args, p) for p in range(3)] == [
        [torch.device("cuda", 0)], [torch.device("cuda", 1)],
        [torch.device("cuda", 0)]]
    args = tcli.build_parser().parse_args(
        ["--device", "cpu", "pod-segment", "--input", "a", "--output", "b"])
    assert tcli._pod_devices(args, 1) == [CPU]
    args = tcli.build_parser().parse_args(
        ["pod-segment", "--input", "a", "--output", "b", "--local-devices"])
    assert tcli._pod_devices(args, 1) == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
