"""Frame parallelism over several processes (hosts) on ``torch.distributed``.

The port of ``iterseg_tpu/parallel/multihost.py``:

- **frames round-robin over processes**: each process segments frames
  ``t % n_hosts == host_id`` on its own devices (``devices=``, the frame
  parallelism of the pipelines' ``segment_stack`` underneath) and writes
  them into ONE shared output zarr, chunked one frame a chunk, so two
  processes never write the same chunk;
- **metric rows gathered**: each process scores its share of the
  evaluation chunk grid; the per-chunk rows are exchanged with
  ``torch.distributed.all_gather_object`` when a process group exists, or
  through part files in the shared output directory when none does, and
  every process finalises the same frame-ordered table, so the CSVs are
  byte-equal to one process's.

The process group is gloo (``init_multihost``): every collective here
carries host data (barriers, metric rows), and no device tensor crosses
processes, so NCCL is not needed, and several processes may share one
card. The library never sets ``CUDA_VISIBLE_DEVICES``; the CLI gives each
process ``cuda:{process_id % device_count}`` unless told otherwise.
"""
from __future__ import annotations

import os
import time

import numpy as np

__all__ = [
    "init_multihost",
    "set_run_nonce",
    "host_frames",
    "multihost_segment_zarr",
    "multihost_accuracy_metrics",
]

# integer-valued metric columns (restored to ints after the float64
# gather so the finalised table matches the single-host dtypes)
_INT_COLUMNS = ("Number objects (GT)", "Number objects (model)",
                "Count difference", "n_predicted", "n_true", "n_diff")
_INT_SUFFIXES = ("_true_positives", "_false_positives", "_false_negatives")


def _group_size():
    """The live process group's world size, or 0 outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


# run nonce scoping the file-based metric exchanges: a crashed run's
# leftover part files can never be consumed by a later run with a
# different nonce, so recovery needs no manual cleanup
_RUN_NONCE = [None]


def set_run_nonce(nonce):
    """Set the exchange-file nonce for this run (the same value on every
    host, e.g. the scheduler's job id)."""
    _RUN_NONCE[0] = None if nonce is None else str(nonce)


def _run_nonce():
    if _RUN_NONCE[0] is not None:
        return _RUN_NONCE[0]
    return os.environ.get("ITERSEG_RUN_NONCE", "")


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, run_nonce=None):
    """Join (or start) a gloo process group.

    ``coordinator_address`` (``host:port`` of process 0) gives
    ``init_method="tcp://..."`` with ``num_processes`` and ``process_id``;
    without it the group reads ``MASTER_ADDR``/``MASTER_PORT``/
    ``WORLD_SIZE``/``RANK`` (``env://``). No-op if a group already exists
    or if ``num_processes == 1``. ``run_nonce``: a string identical on every
    host of THIS run that scopes the file-based metric exchange
    (``_allgather_rows``); falls back to ``ITERSEG_RUN_NONCE``."""
    import torch.distributed as dist

    if run_nonce is not None:
        set_run_nonce(run_nonce)
    if num_processes == 1 or _group_size():
        return
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=init_method, **kwargs)


def _resolve_host(host_id, n_hosts):
    """host coordinates: explicit args > the process group > env > solo."""
    if host_id is not None and n_hosts is not None:
        return int(host_id), int(n_hosts)
    if _group_size():
        import torch.distributed as dist

        return dist.get_rank(), dist.get_world_size()
    if "ITERSEG_HOST_ID" in os.environ:
        return (int(os.environ["ITERSEG_HOST_ID"]),
                int(os.environ.get("ITERSEG_N_HOSTS", "1")))
    return 0, 1


def host_frames(n_frames, host_id=None, n_hosts=None):
    """The frames this host owns: round-robin ``t % n_hosts == host_id``
    (deterministic, balanced, and stable under warm restart)."""
    host_id, n_hosts = _resolve_host(host_id, n_hosts)
    return [t for t in range(int(n_frames)) if t % n_hosts == host_id]


def _barrier(name):
    """Barrier across the process group (a no-op without one). ``name``
    says in a traceback which barrier hung."""
    if _group_size() > 1:
        import torch.distributed as dist

        dist.barrier()


def _wait_for_zarr(path, timeout_s=120.0):
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(str(path), ".zarray")):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"no zarr appeared at {path}")
        time.sleep(0.05)


def _prep(segmenter, data_layer, network_or_config_file):
    """(processing_function, config) for a registry segmenter, headless."""
    from ..engine import segmentation as seg

    if segmenter == "affinity-unet-watershed":
        config = seg.affinity_watershed_prep_config(
            data_layer, network_or_config_file, None
        )
        return seg.affinity_watershed_for_chunks, config
    if segmenter == "DoG-blob-watershed":
        config = seg.dog_blob_watershed_prep_config(
            data_layer, network_or_config_file, None
        )
        return seg.dog_blob_watershed_for_chunks, config
    raise ValueError(f"unknown segmenter {segmenter!r}")


class _FrameSubset:
    """4D-stack view of selected frame indices of a (possibly 3D) array."""

    def __init__(self, data, idxs):
        self._data = data
        self._idxs = list(idxs)
        zyx = tuple(data.shape[-3:])
        self.shape = (len(self._idxs),) + zyx
        self.ndim = 4

    def __getitem__(self, t):
        if getattr(self._data, "ndim", 4) == 3:
            return np.asarray(self._data[...])
        return np.asarray(self._data[self._idxs[t]])


class _FrameSubsetOut:
    """Write adapter: local frame t → global frame idxs[t] of the store."""

    def __init__(self, out, idxs):
        self._out = out
        self._idxs = list(idxs)
        self.shape = (len(self._idxs),) + tuple(out.shape[-3:])

    @staticmethod
    def _frame(t):
        # accept the driver's `labels[t, ...]` form as well as plain ints
        if isinstance(t, tuple):
            t = t[0]
        return t

    def __getitem__(self, t):
        return self._out[self._idxs[self._frame(t)]]

    def __setitem__(self, t, value):
        self._out[self._idxs[self._frame(t)]] = (
            np.asarray(value).astype(np.uint32)
        )


def multihost_segment_zarr(
    input_zarr,
    output_zarr,
    segmenter="affinity-unet-watershed",
    network_or_config_file=None,
    chunk_size=(10, 256, 256),
    margin=(1, 64, 64),
    host_id=None,
    n_hosts=None,
    devices=None,
):
    """Segment a (t, z, y, x) zarr timeseries across hosts.

    Every host runs this same call. Host 0 creates the shared output zarr
    (uint32, one frame a chunk); after a barrier the others open it (or,
    without a process group, wait for it to appear). Each host then
    segments its round-robin share of frames through
    ``segmentation_loop`` (the pipelines' ``segment_stack``, warm restart
    included: frames already labelled are skipped) on ``devices`` (this
    host's own; ``None``: CUDA) and writes its own chunks. Returns the
    frames this host processed. Labels are those of one process on one
    device."""
    from ..engine.segmentation import _as_layer, segmentation_loop
    from ..io.zarr_io import open_zarr

    host_id, n_hosts = _resolve_host(host_id, n_hosts)
    data = open_zarr(input_zarr)
    if data.ndim == 3:
        shape = (1,) + tuple(data.shape)
    else:
        shape = tuple(data.shape)
    n_frames, zyx = shape[0], shape[1:]

    if host_id == 0:
        out = open_zarr(output_zarr, shape=shape, chunks=(1,) + tuple(zyx),
                        dtype=np.uint32)
    _barrier("iterseg:output_created")
    if host_id != 0:
        _wait_for_zarr(output_zarr)
        out = open_zarr(output_zarr)

    layer = _as_layer(data)
    fn, config = _prep(segmenter, layer, network_or_config_file)

    mine = host_frames(n_frames, host_id, n_hosts)
    done = []
    if mine:
        if devices is not None:
            config["devices"] = list(devices)
        sub_in = _FrameSubset(data, mine)
        sub_out = _FrameSubsetOut(out, mine)
        for t_local in segmentation_loop(
            None, sub_in, chunk_size, margin, sub_out, fn, config,
        ):
            done.append(mine[t_local])
    _barrier("iterseg:segment_done")
    return done


# ---------------------------------------------------------------------------
# Metrics: shard the evaluation chunk grid, gather the rows
# ---------------------------------------------------------------------------


def _rows_to_matrix(indexed_rows, columns, n_total):
    """(chunk_id, {col: value}) rows -> NaN-padded (n_total, 1+C) float64."""
    mat = np.full((n_total, 1 + len(columns)), np.nan, dtype=np.float64)
    for r, (idx, row) in enumerate(indexed_rows):
        mat[r, 0] = idx
        for c, col in enumerate(columns):
            mat[r, 1 + c] = row[col]
    return mat


# per-process sequence number for file-based exchanges: successive
# exchanges with the same tag in one run get distinct filenames
_EXCHANGE_SEQ = {}


def _allgather_rows(mat, save_dir, host_id, n_hosts, tag):
    """Gather the hosts' NaN-padded row matrices, in host order.

    With a process group: ``all_gather_object`` (the float64 rows are
    pickled, so they cross exactly). Without one: part files in
    ``save_dir``, a directory every host sees (the shared output zarr makes
    the same assumption), scoped by the run nonce and a per-process
    sequence number. A host refuses to start if its own part file already
    exists (a duplicate nonce fails loudly), and parts are deleted only
    after every host has signalled that it read them."""
    if _group_size() > 1:
        import torch.distributed as dist

        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, mat)
        return np.concatenate(parts, axis=0)
    if n_hosts == 1:
        return mat
    if save_dir is None:
        raise ValueError(
            "multihost metrics without a process group exchange part "
            "files through the output directory: pass out_path= (a "
            "directory every host sees)"
        )
    # keyed by (tag, host): hosts perform the same exchange sequence, and
    # keying by host keeps thread-simulated hosts in one process aligned
    seq = _EXCHANGE_SEQ.get((tag, host_id), 0)
    _EXCHANGE_SEQ[(tag, host_id)] = seq + 1
    nonce = _run_nonce()
    xtag = f"{tag}_{nonce}_x{seq}" if nonce else f"{tag}_x{seq}"
    os.makedirs(save_dir, exist_ok=True)
    part = os.path.join(save_dir, f".{xtag}_part{host_id}.npy")
    if os.path.exists(part):
        raise RuntimeError(
            f"exchange file {part} already exists for THIS run's nonce — "
            "two runs are sharing a nonce (or one host ran the exchange "
            "twice); give each run a distinct init_multihost(run_nonce=...) "
            "and rerun"
        )
    tmp = part + ".tmp.npy"  # np.save appends .npy to bare names
    np.save(tmp, mat)
    os.replace(tmp, part)
    parts = {}
    t0 = time.monotonic()
    for h in range(n_hosts):
        p = os.path.join(save_dir, f".{xtag}_part{h}.npy")
        while not os.path.exists(p):
            if time.monotonic() - t0 > 300:
                raise TimeoutError(f"missing metrics part {p}")
            time.sleep(0.05)
        while True:  # the writer may still be mid-rename on slow stores
            try:
                parts[h] = np.load(p)
                break
            except (ValueError, EOFError, FileNotFoundError):
                time.sleep(0.05)
    done = os.path.join(save_dir, f".{xtag}_done{host_id}")
    with open(done, "w"):
        pass
    t0 = time.monotonic()
    for h in range(n_hosts):
        d = os.path.join(save_dir, f".{xtag}_done{h}")
        while not os.path.exists(d):
            if time.monotonic() - t0 > 300:
                raise TimeoutError(f"missing done marker {d}")
            time.sleep(0.05)
    try:
        os.remove(part)
    except OSError:
        pass
    # the last host to clean up also sweeps the markers (best effort)
    if not any(os.path.exists(os.path.join(save_dir, f".{xtag}_part{h}.npy"))
               for h in range(n_hosts)):
        for h in range(n_hosts):
            try:
                os.remove(os.path.join(save_dir, f".{xtag}_done{h}"))
            except OSError:
                pass
    return np.concatenate([parts[h] for h in range(n_hosts)], axis=0)


def multihost_accuracy_metrics(
    slices,
    gt_data,
    model_result,
    name: str,
    prefix: str,
    VI: bool = True,
    AP: bool = True,
    ND: bool = True,
    out_path=None,
    exclude_chunks: int = 10,
    host_id=None,
    n_hosts=None,
):
    """``get_accuracy_metrics`` sharded over hosts.

    Each host scores chunks ``i % n_hosts == host_id`` of the same chunk
    list, the per-chunk rows are gathered, ordered by chunk index and
    finalised with the single-host tail (stats, AP curve, CSVs): every host
    returns ``get_accuracy_metrics``' column dicts, and host 0 writes CSVs
    byte-equal to one host's. Zarr-backed inputs stay on disk: each host
    reads only its own chunks."""
    from ..eval.metrics import (_collect_chunk_scores, _finalize_scores,
                                _layer_data, generate_IoU_dict)

    host_id, n_hosts = _resolve_host(host_id, n_hosts)
    slices = list(slices)
    # 3D<->4D promotion once, up front (per-chunk calls would otherwise
    # re-stack the whole volume for every chunk); broadcast_to copies
    # nothing
    gt_data = _layer_data(gt_data, lazy=True)
    model_result = _layer_data(model_result, lazy=True)
    if gt_data.ndim == 3 and model_result.ndim == 4:
        gt_data = np.broadcast_to(
            np.asarray(gt_data), (model_result.shape[0],) + gt_data.shape
        )
    elif model_result.ndim == 3 and gt_data.ndim == 4:
        model_result = np.broadcast_to(
            np.asarray(model_result),
            (gt_data.shape[0],) + model_result.shape
        )
    elif gt_data.ndim == 3 and model_result.ndim == 3:
        gt_data = np.asarray(gt_data)[None]
        model_result = np.asarray(model_result)[None]
    template = {
        "VI: GT | Output": [],
        "VI: Output | GT": [],
        "Number objects (GT)": [],
        "Number objects (model)": [],
        "Count difference": [],
        "Count difference (%)": [],
    }
    template.update(generate_IoU_dict())
    columns = list(template)

    indexed_rows = []
    for i in range(host_id, len(slices), n_hosts):
        rows = _collect_chunk_scores(
            [slices[i]], gt_data, model_result, VI=VI, AP=AP, ND=ND,
            exclude_chunks=exclude_chunks,
        )
        if not any(len(v) for v in rows.values()):
            continue  # chunk excluded (too few GT objects)
        indexed_rows.append(
            (i, {col: rows[col][0] for col in columns if rows[col]})
        )

    # the live column set comes from the flags (the same on every host),
    # and the matrix is padded to the chunk count, so the gathered shapes
    # agree across hosts
    live_cols = []
    if VI:
        live_cols += ["VI: GT | Output", "VI: Output | GT"]
    if AP:
        live_cols += list(generate_IoU_dict())
    if ND:
        live_cols += ["Number objects (GT)", "Number objects (model)",
                      "Count difference", "Count difference (%)"]
    mat = _rows_to_matrix(indexed_rows, live_cols, len(slices))
    gathered = _allgather_rows(
        mat, out_path, host_id, n_hosts, tag=f"{prefix}_{name}"
    )
    gathered = gathered[np.isfinite(gathered[:, 0])]
    gathered = gathered[np.argsort(gathered[:, 0], kind="stable")]

    scores = {col: [] for col in columns}
    for row in gathered:
        for c, col in enumerate(live_cols):
            v = row[1 + c]
            if col in _INT_COLUMNS or col.endswith(_INT_SUFFIXES):
                v = int(v)
            scores[col].append(v)
    # CSVs from host 0 only (one writer on the shared filesystem)
    return _finalize_scores(
        scores, name, prefix, out_path if host_id == 0 else None, AP=AP
    )
