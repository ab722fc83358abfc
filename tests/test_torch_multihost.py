"""The port's multi-host frame parallelism
(``iterseg_tpu_torch.parallel.multihost``), case for case with
``tests/test_multihost.py``, exercised with REAL processes.

Two Python processes join a gloo process group (``torch.distributed``,
``init_multihost``), segment disjoint round-robin frame shards of one
shared zarr and gather their metric rows; everything is compared with one
process:

- DoG labels bit-equal to the port's one-process labels and to the JAX
  package's single-host labels (the DoG path is bit-equal op by op), and
  the metrics CSVs byte-equal to one process's ``get_accuracy_metrics``;
  this pod runs on the bundled pure-numpy zarr driver (the card's machine
  has no tensorstore), so its writes to one store from two processes are
  held too;
- the affinity segmenter with a full-width random U-Net, each process
  round-robining its frames over two devices: bit-equal to one process;
- the file gather without a process group (threads stand in for hosts),
  its guards, and the lazy zarr metrics path; the metrics equal the JAX
  module's.
"""
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from conftest import cpu_subprocess_env
from iterseg_tpu.parallel import multihost as jmh
from iterseg_tpu_torch.core.chunks import get_slices_from_chunks
from iterseg_tpu_torch.eval.metrics import get_accuracy_metrics
from iterseg_tpu_torch.io.zarr_io import open_zarr, zarr_save
from iterseg_tpu_torch.parallel import multihost as mh
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CHUNK = (8, 32, 32)
MARGIN = (1, 4, 4)
CSVS = ("metrics_mh_scores.csv", "metrics_mh_stats.csv",
        "metrics_mh_AP_curve.csv")

_DRIVER = """
import os, sys
pid, port, root, seg, out, n_dev = (int(sys.argv[1]), sys.argv[2],
                                    sys.argv[3], sys.argv[4], sys.argv[5],
                                    int(sys.argv[6]))
import numpy as np
import torch
torch.set_num_threads(1)
from iterseg_tpu_torch.parallel import multihost as mh
import torch.distributed as dist

mh.init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert dist.get_world_size() == 2 and dist.get_rank() == pid
net = os.path.join(root, "u.npz") if seg.startswith("affinity") else None
done = mh.multihost_segment_zarr(
    os.path.join(root, "in.zarr"), os.path.join(root, out),
    segmenter=seg, network_or_config_file=net, chunk_size=(8, 32, 32),
    margin=(1, 4, 4), devices=[torch.device("cpu")] * n_dev,
)
assert all(t % 2 == pid for t in done), (pid, done)
if seg.startswith("DoG"):
    from iterseg_tpu_torch.core.chunks import get_slices_from_chunks
    from iterseg_tpu_torch.io.zarr_io import open_zarr

    gt = np.asarray(open_zarr(os.path.join(root, "gt.zarr")))
    labels = np.asarray(open_zarr(os.path.join(root, out)))
    slices = get_slices_from_chunks(labels.shape, (8, 32, 32), (1, 4, 4))
    mh.multihost_accuracy_metrics(
        slices, gt, labels, "mh", "metrics", exclude_chunks=2,
        out_path=os.path.join(root, "mh_metrics"),
    )
print("HOST", pid, "DONE", done, flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pod(root, segmenter, out, n_devices=1, **env):
    """Two gloo processes of ``_DRIVER``; returns their outputs."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DRIVER, str(pid), str(port), str(root),
         segmenter, out, str(n_devices)],
        cwd=ROOT, env=cpu_subprocess_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {pid} failed:\n{o[-3000:]}"
        assert f"HOST {pid} DONE" in o
    return outs


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """A 4-frame blob stack, its zarr and a thresholded 'ground truth',
    written by the bundled numpy zarr driver, and the one-process DoG
    labels of the same entry point."""
    root = tmp_path_factory.mktemp("torch-mh")
    r = np.random.default_rng(7)
    frames = []
    for _ in range(4):
        vol = np.zeros((16, 64, 64), np.float32)
        pts = np.stack([r.integers(2, s - 2, size=24) for s in vol.shape], 1)
        vol[tuple(pts.T)] = 1.0
        vol = ndi.gaussian_filter(vol, (1, 1.5, 1.5))
        frames.append(vol / vol.max())
    data = np.stack(frames)
    gt = np.stack([ndi.label(f > 0.25 * f.max())[0] for f in data])
    with pytest.MonkeyPatch.context() as m:
        m.setenv("ITERSEG_TPU_NO_TENSORSTORE", "1")
        zarr_save(str(root / "in.zarr"), data)
        zarr_save(str(root / "gt.zarr"), gt.astype(np.uint32))
        mh.multihost_segment_zarr(
            str(root / "in.zarr"), str(root / "out_single.zarr"),
            segmenter="DoG-blob-watershed", chunk_size=CHUNK, margin=MARGIN,
            host_id=0, n_hosts=1, devices=[CPU],
        )
        golden = np.asarray(open_zarr(str(root / "out_single.zarr")))
    return root, data, gt, golden


def test_host_frames_round_robin():
    assert mh.host_frames(5, host_id=0, n_hosts=2) == [0, 2, 4]
    assert mh.host_frames(5, host_id=1, n_hosts=2) == [1, 3]
    assert mh.host_frames(3, host_id=0, n_hosts=1) == [0, 1, 2]
    for n in range(1, 7):
        for h in range(3):
            assert mh.host_frames(n, h, 3) == jmh.host_frames(n, h, 3)


def test_resolve_host_env_and_solo(monkeypatch):
    monkeypatch.delenv("ITERSEG_HOST_ID", raising=False)
    assert mh._resolve_host(None, None) == (0, 1)
    monkeypatch.setenv("ITERSEG_HOST_ID", "2")
    monkeypatch.setenv("ITERSEG_N_HOSTS", "3")
    assert mh._resolve_host(None, None) == (2, 3)
    assert mh._resolve_host(1, 2) == (1, 2)
    mh.init_multihost(num_processes=1, run_nonce="n1")  # solo: no group
    try:
        assert mh._group_size() == 0 and mh._run_nonce() == "n1"
    finally:
        mh.set_run_nonce(None)


def test_prep_affinity_segmenter(tmp_path):
    """The affinity branch of the pod prep resolves a checkpoint and
    allocates the per-frame scratch like the single-host prep."""
    from iterseg_tpu_torch.engine.segmentation import (
        _as_layer, affinity_watershed_for_chunks)
    from iterseg_tpu_torch.models.convert import save_checkpoint
    from iterseg_tpu_torch.models.convert import params_to_numpy
    from iterseg_tpu_torch.models.unet import UNet, UNetSpec

    ck = str(tmp_path / "u.npz")
    save_checkpoint(params_to_numpy(UNet(UNetSpec(1, 5)).init_weights(0)),
                    ck)
    layer = _as_layer(np.zeros((2, 8, 32, 32), np.float32))
    fn, config = mh._prep("affinity-unet-watershed", layer, ck)
    assert fn is affinity_watershed_for_chunks
    assert config["unet"].out_channels == 5
    assert config["output_volume"].shape == (5, 8, 32, 32)
    with pytest.raises(ValueError):
        mh._prep("not-a-segmenter", layer, None)


def test_two_process_pod_matches_single_host(stack):
    """DoG over two gloo processes on the numpy zarr driver: the labels of
    one process and of JAX's single host, the CSVs of one process."""
    root, data, gt, golden = stack
    assert golden.max() > 0
    jmh.multihost_segment_zarr(
        str(root / "in.zarr"), str(root / "out_jax.zarr"),
        segmenter="DoG-blob-watershed", chunk_size=CHUNK, margin=MARGIN,
        host_id=0, n_hosts=1,
    )
    from iterseg_tpu.io.zarr_io import open_zarr as jax_open_zarr

    np.testing.assert_array_equal(
        golden, np.asarray(jax_open_zarr(str(root / "out_jax.zarr"))))
    slices = get_slices_from_chunks(golden.shape, CHUNK, MARGIN)
    get_accuracy_metrics(slices, gt, golden, "mh", "metrics",
                         exclude_chunks=2,
                         out_path=str(root / "single_metrics"))

    run_pod(root, "DoG-blob-watershed", "out_mh.zarr",
            ITERSEG_TPU_NO_TENSORSTORE="1")
    with pytest.MonkeyPatch.context() as m:
        m.setenv("ITERSEG_TPU_NO_TENSORSTORE", "1")
        pod = np.asarray(open_zarr(str(root / "out_mh.zarr")))
    np.testing.assert_array_equal(pod, golden)
    assert not [f for f in os.listdir(root / "out_mh.zarr")
                if f.endswith(".tmp")]
    for fname in CSVS:
        assert (root / "mh_metrics" / fname).read_bytes() == (
            root / "single_metrics" / fname).read_bytes(), fname


def test_two_process_pod_with_two_devices_each_matches_single_host(
        stack, tmp_path):
    """The affinity segmenter with a full-width random U-Net: two gloo
    processes, each round-robining its frames over two devices, give the
    labels of one process on one device."""
    from iterseg_tpu_torch.models.convert import params_to_numpy
    from iterseg_tpu_torch.models.convert import save_checkpoint
    from iterseg_tpu_torch.models.unet import UNet, UNetSpec

    root, data, _, _ = stack
    save_checkpoint(params_to_numpy(UNet(UNetSpec(1, 5)).init_weights(0)),
                    str(root / "u.npz"))
    with pytest.MonkeyPatch.context() as m:
        m.setenv("ITERSEG_TPU_NO_TENSORSTORE", "1")
        mh.multihost_segment_zarr(
            str(root / "in.zarr"), str(root / "out_auw_single.zarr"),
            segmenter="affinity-unet-watershed",
            network_or_config_file=str(root / "u.npz"), chunk_size=CHUNK,
            margin=MARGIN, host_id=0, n_hosts=1, devices=[CPU])
        golden = np.asarray(open_zarr(str(root / "out_auw_single.zarr")))
        run_pod(root, "affinity-unet-watershed", "out_auw_mh.zarr",
                n_devices=2, ITERSEG_TPU_NO_TENSORSTORE="1")
        pod = np.asarray(open_zarr(str(root / "out_auw_mh.zarr")))
    assert golden.max() > 0
    np.testing.assert_array_equal(pod, golden)


def test_metrics_file_gather_matches_single_host(stack, tmp_path):
    """The no-process-group fallback: rows exchanged via part files (two
    hosts simulated with threads in this one process)."""
    root, data, gt, golden = stack
    slices = get_slices_from_chunks(golden.shape, CHUNK, MARGIN)
    (g_scores, g_ap), g_stats = get_accuracy_metrics(
        slices, gt, golden, "mh", "metrics", exclude_chunks=2,
        out_path=str(tmp_path / "single"))
    results = {}

    def run(host):
        results[host] = mh.multihost_accuracy_metrics(
            slices, gt, golden, "mh", "metrics", exclude_chunks=2,
            out_path=str(tmp_path / "pod"), host_id=host, n_hosts=2,
        )

    threads = [threading.Thread(target=run, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert set(results) == {0, 1}
    for host in (0, 1):
        (scores, ap), stats = results[host]
        for got, want in ((scores, g_scores), (ap, g_ap), (stats, g_stats)):
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]))
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    for fname in CSVS:
        assert (tmp_path / "pod" / fname).read_bytes() == (
            tmp_path / "single" / fname).read_bytes(), fname
    assert not list((tmp_path / "pod").glob(".*part*"))


def test_metrics_equal_the_jax_module(stack, tmp_path):
    """The port's sharded metrics write the CSVs of the JAX module's
    (pandas) on the same labels."""
    root, data, gt, golden = stack
    slices = get_slices_from_chunks(golden.shape, CHUNK, MARGIN)
    mh.multihost_accuracy_metrics(slices, gt, golden, "mh", "metrics",
                                  exclude_chunks=2,
                                  out_path=str(tmp_path / "t"),
                                  host_id=0, n_hosts=1)
    jmh.multihost_accuracy_metrics(slices, gt, golden, "mh", "metrics",
                                   exclude_chunks=2,
                                   out_path=str(tmp_path / "j"),
                                   host_id=0, n_hosts=1)
    for fname in CSVS:
        assert (tmp_path / "t" / fname).read_bytes() == (
            tmp_path / "j" / fname).read_bytes(), fname


def test_file_gather_requires_out_path():
    with pytest.raises(ValueError, match="out_path"):
        mh._allgather_rows(np.zeros((1, 3)), None, host_id=0, n_hosts=2,
                           tag="t")


def test_file_gather_ignores_stale_foreign_nonce(tmp_path):
    """Leftover part files from a crashed run (another nonce) are
    invisible to a new run."""
    np.save(tmp_path / ".t_deadrun_x0_part0.npy", np.full((2, 3), -1.0))
    (tmp_path / ".t_deadrun_x0_done0").touch()
    mh.set_run_nonce("live123")
    try:
        mats = {0: np.arange(6.0).reshape(2, 3),
                1: np.arange(6.0, 12.0).reshape(2, 3)}
        results = {}

        def run(host):
            results[host] = mh._allgather_rows(
                mats[host], str(tmp_path), host_id=host, n_hosts=2, tag="t")

        threads = [threading.Thread(target=run, args=(h,)) for h in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        expected = np.concatenate([mats[0], mats[1]], axis=0)
        for host in (0, 1):
            np.testing.assert_array_equal(results[host], expected)
        assert (tmp_path / ".t_deadrun_x0_part0.npy").exists()
        assert not list(tmp_path.glob(".t_live123*part*.npy"))
    finally:
        mh.set_run_nonce(None)


def test_same_nonce_duplicate_fails_loud(tmp_path):
    mh.set_run_nonce("dup")
    try:
        np.save(tmp_path / ".t2_dup_x0_part0.npy", np.zeros((1, 3)))
        with pytest.raises(RuntimeError, match="nonce"):
            mh._allgather_rows(np.zeros((1, 3)), str(tmp_path), host_id=0,
                               n_hosts=2, tag="t2")
    finally:
        mh.set_run_nonce(None)


def test_metrics_lazy_zarr_inputs_match_numpy(stack):
    """Zarr-backed gt/labels go through the lazy path (each host reads only
    its chunks) and give the numpy path's columns."""
    root, data, gt, golden = stack
    with pytest.MonkeyPatch.context() as m:
        m.setenv("ITERSEG_TPU_NO_TENSORSTORE", "1")
        golden_z = open_zarr(str(root / "out_single.zarr"))
        gt_z = open_zarr(str(root / "gt.zarr"))
        slices = get_slices_from_chunks(golden.shape, CHUNK, MARGIN)
        (n_scores, n_ap), n_stats = mh.multihost_accuracy_metrics(
            slices, gt, golden, "mh", "lazy", exclude_chunks=2,
            out_path=None, host_id=0, n_hosts=1)
        (z_scores, z_ap), z_stats = mh.multihost_accuracy_metrics(
            slices, gt_z, golden_z, "mh", "lazy", exclude_chunks=2,
            out_path=None, host_id=0, n_hosts=1)
    for got, want in ((z_scores, n_scores), (z_ap, n_ap),
                      (z_stats, n_stats)):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
