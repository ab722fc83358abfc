"""The port's warm server and watch loop (``iterseg_tpu_torch.engine.serve``)
on the CPU: the watch-directory protocol gives JAX's pending lists, one
config serves many volumes, crash-resume redoes only the missing frame,
failures are collected, and served labels are bit-equal to one-shot
``segment_data``."""
import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image as PILImage
from scipy import ndimage as ndi

from iterseg_tpu.engine import serve as jserve
from iterseg_tpu_torch.cli import main
from iterseg_tpu_torch.engine.serve import (SegmentationServer,
                                            scan_watch_dir, watch)
from iterseg_tpu_torch.io.zarr_io import (load_ome_zarr, open_zarr,
                                          save_labels_to_ome)
from iterseg_tpu_torch.widgets import segment_data
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
CHUNK, MARGIN = (8, 48, 48), (1, 8, 8)


def blobs(shape=(8, 48, 48), n=30, seed=0):
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    for c in np.stack([r.integers(2, s - 2, size=n) for s in shape], 1):
        vol[tuple(c)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 2, 2))
    return (vol / vol.max()).astype(np.float32)


def save_zarr(path, data):
    arr = open_zarr(str(path), shape=data.shape, chunks=data.shape,
                    dtype=np.float32)
    arr[...] = data
    return str(path)


def dog_server(**kw):
    return SegmentationServer("DoG-blob-watershed", chunk_size=CHUNK,
                              margin=MARGIN, devices=[CPU], **kw)


def touch_in_order(paths):
    """Distinct, increasing mtimes (the pending list is oldest first)."""
    now = time.time()
    for i, p in enumerate(paths):
        os.utime(p, (now - 100 + i, now - 100 + i))


def scenario(tmp_path, name):
    """A watch and an output directory in one of the protocol's states."""
    w, o = tmp_path / name / "in", tmp_path / name / "out"
    os.makedirs(w)
    os.makedirs(o)
    small = blobs(shape=(6, 16, 16), n=3)
    if name == "collision":
        save_zarr(w / "vol.zarr", small)
        PILImage.fromarray(small[0]).save(w / "vol.tif")
        save_zarr(w / "other.zar", small)
        touch_in_order([w / "vol.tif", w / "other.zar", w / "vol.zarr"])
    elif name == "marker-for-other-source":
        save_zarr(w / "vol.zarr", small)
        PILImage.fromarray(small[0]).save(w / "vol.tiff")
        (o / "vol.done").write_text("vol.tiff\n0.500s\n")
        touch_in_order([w / "vol.zarr", w / "vol.tiff"])
    elif name == "legacy-marker":
        save_zarr(w / "a.zarr", small)
        save_zarr(w / "b.zarr", small)
        (o / "a.done").write_text("1.250s\n")
        (o / "b-zarr.done").write_text("b.zarr\n0.1s\n")
        touch_in_order([w / "b.zarr", w / "a.zarr"])
    elif name == "ome-root-and-half-written":
        save_labels_to_ome(str(w / "ome.zarr"), data=small,
                           layer_meta={"scale": (1.0,) * 3,
                                       "translate": (0.0,) * 3, "name": "v"})
        os.makedirs(w / "half.zarr")
        os.makedirs(w / "dir-not-store")
        (w / "notes.txt").write_text("x")
        save_zarr(w / "done.zarr", small)
        (o / "done.done").write_text("done.zarr\n0.2s\n")
    return str(w), str(o)


@pytest.mark.parametrize("name", ["collision", "marker-for-other-source",
                                  "legacy-marker",
                                  "ome-root-and-half-written"])
def test_scan_watch_dir_equals_jax(tmp_path, name):
    w, o = scenario(tmp_path, name)
    got = scan_watch_dir(w, o)
    assert got == jserve.scan_watch_dir(w, o)
    assert got
    if name == "collision":
        assert [s for _, s, _ in got] == ["vol", "other", "vol-zarr"]


def test_server_warm_reuse_and_identity(tmp_path):
    """Two volumes through one server: the config (pipeline cache) is built
    once and reused, labels bit-match the one-shot ``segment_data``."""
    server = dog_server()
    v0, v1 = blobs(seed=0), blobs(seed=1)
    out0 = server.segment_to(v0, tmp_path / "a.ome.zarr", name="a")
    cfg = server._config
    assert cfg is not None and cfg.get("pipeline_cache")
    out1 = server.segment_to(v1, tmp_path / "b.ome.zarr", name="b")
    assert server._config is cfg
    ref = segment_data(None, v1, str(tmp_path / "ref"), "oneshot",
                       "DoG-blob-watershed", chunk_size=CHUNK, margin=MARGIN,
                       debug=False, devices=[CPU])
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(ref))
    assert np.asarray(out0).max() > 0


def test_server_shape_change(tmp_path):
    server = SegmentationServer(chunk_size=CHUNK, margin=MARGIN,
                                devices=[CPU])
    server.segment_to(blobs(), tmp_path / "a.ome.zarr")
    model = server._config["unet"]
    out = server.segment_to(blobs(shape=(6, 32, 32), n=10),
                            tmp_path / "b.ome.zarr")
    assert np.asarray(out).shape == (6, 32, 32)
    assert server._config["output_volume"].shape[1:] == (6, 32, 32)
    assert server._config["unet"] is model  # loaded exactly once


@pytest.mark.parametrize("flood", [None, "pallas", "xla", "exact"])
def test_served_affinity_equals_segment_data(tmp_path, flood):
    """A JSON config names the U-Net and the flood; the served labels of a
    volume and a stack equal one-shot ``segment_data`` with the same
    config, bit for bit."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"unet": "default", "device_flood": flood}))
    w, o = tmp_path / "in", tmp_path / "out"
    os.makedirs(w)
    vol = blobs(seed=3)
    stack = np.stack([blobs(seed=4), blobs(seed=5)])
    save_zarr(w / "vol.zarr", vol)
    save_zarr(w / "stack.zarr", stack)
    touch_in_order([w / "vol.zarr", w / "stack.zarr"])
    server = SegmentationServer(network_or_config_file=str(cfg),
                                chunk_size=CHUNK, margin=MARGIN,
                                devices=[CPU])
    assert watch(str(w), str(o), server, once=True) == ["vol", "stack"]
    assert server._config["device_flood"] == (flood or False)
    for stem, data in (("vol", vol), ("stack", stack)):
        [(served, _, lt)] = load_ome_zarr(str(o / f"{stem}.ome.zarr"))
        want = segment_data(None, data, None, stem,
                            network_or_config_file=str(cfg),
                            chunk_size=CHUNK, margin=MARGIN, devices=[CPU])
        assert lt == "labels" and np.asarray(served).max() > 0
        np.testing.assert_array_equal(np.asarray(served), want)
        assert (o / f"{stem}.done").read_text().startswith(f"{stem}.zarr\n")


def test_watch_protocol(tmp_path):
    w, o = tmp_path / "in", tmp_path / "out"
    os.makedirs(w)
    save_zarr(w / "v0.zarr", blobs(seed=0))
    save_zarr(w / "v1.zarr", blobs(seed=1))
    touch_in_order([w / "v0.zarr", w / "v1.zarr"])
    os.makedirs(w / "half.zarr")  # producer still writing: no .zarray
    server = dog_server()
    assert watch(str(w), str(o), server, once=True) == ["v0", "v1"]
    assert scan_watch_dir(str(w), str(o)) == []
    mtime = os.path.getmtime(o / "v0.done")
    assert watch(str(w), str(o), server, once=True) == []
    assert os.path.getmtime(o / "v0.done") == mtime
    save_zarr(w / "v2.zarr", blobs(seed=2))
    assert watch(str(w), str(o), server, once=True, max_volumes=1) == ["v2"]


def test_watch_crash_resume(tmp_path):
    """A crashed serve (no marker, a frame zeroed) resumes by the warm
    restart: the labelled frame is left as it is, only the zeroed frame is
    segmented again."""
    w, o = tmp_path / "in", tmp_path / "out"
    os.makedirs(w)
    stack = np.stack([blobs(seed=0), blobs(seed=1)])
    arr = open_zarr(w / "stack.zarr", shape=stack.shape,
                    chunks=(1,) + stack.shape[1:], dtype=np.float32)
    arr[...] = stack
    server = dog_server()
    assert watch(str(w), str(o), server, once=True) == ["stack"]
    first = np.asarray(open_zarr(str(o / "stack.ome.zarr" / "0")))
    os.remove(o / "stack.done")
    out = open_zarr(str(o / "stack.ome.zarr" / "0"))
    out[0] = np.full(stack.shape[1:], 7, dtype=np.int32)
    out[1] = np.zeros(stack.shape[1:], np.int32)
    assert watch(str(w), str(o), server, once=True) == ["stack"]
    resumed = np.asarray(open_zarr(str(o / "stack.ome.zarr" / "0")))
    np.testing.assert_array_equal(resumed[0], 7)  # skipped, not redone
    np.testing.assert_array_equal(resumed[1], first[1])


def test_failures_collected_and_exit_status(tmp_path, capsys):
    w, o = tmp_path / "in", tmp_path / "out"
    os.makedirs(w)
    bad = w / "bad.zarr"
    os.makedirs(bad)
    (bad / ".zarray").write_text("not json")
    save_zarr(w / "good.zarr", blobs())
    errors = []
    assert watch(str(w), str(o), dog_server(), once=True,
                 errors=errors) == ["good"]
    assert len(errors) == 1 and errors[0][0].endswith("bad.zarr")
    assert "ERROR serving" in capsys.readouterr().out
    assert not (o / "bad.done").exists()
    assert [s for _, s, _ in scan_watch_dir(str(w), str(o))] == ["bad"]
    assert main(["--device", "cpu", "serve", "--watch-dir", str(w),
                 "--output-dir", str(o), "--segmenter",
                 "DoG-blob-watershed", "--once"]) == 1


def test_serve_once_cli(tmp_path, capsys):
    w, o = tmp_path / "in", tmp_path / "out"
    os.makedirs(w)
    save_zarr(w / "vol.zarr", blobs(shape=(8, 64, 64)))
    assert main(["--device", "cpu", "serve", "--watch-dir", str(w),
                 "--output-dir", str(o), "--segmenter",
                 "DoG-blob-watershed", "--chunk-size", "8,48,48",
                 "--margin", "1,8,8", "--once", "--pyramid-levels", "1"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == str(
        o / "vol.ome.zarr")
    lvl0 = np.asarray(open_zarr(str(o / "vol.ome.zarr" / "0")))
    lvl1 = np.asarray(open_zarr(str(o / "vol.ome.zarr" / "1")))
    np.testing.assert_array_equal(lvl1, lvl0[..., ::2, ::2])


def test_server_refuses_unknown_segmenter_and_several_devices():
    """An unknown segmenter is refused; several devices are taken (the
    frames of a stack round-robin over them)."""
    with pytest.raises(ValueError, match="unknown segmenter"):
        SegmentationServer("nope", devices=[CPU])
    assert SegmentationServer(devices=[CPU, CPU]).devices == [CPU, CPU]
