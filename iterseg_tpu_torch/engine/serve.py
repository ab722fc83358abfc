"""Prep-once, serve-many segmentation (production serving mode).

The port of ``iterseg_tpu/engine/serve.py``. One process keeps one loaded
U-Net, one pipeline cache and the CUDA kernels it has built alive across
many volumes, so every volume after the first skips the checkpoint load,
the cuDNN set-up and the kernel builds:

- ``SegmentationServer``: resolves the segmenter config ONCE (the U-Net
  load + scratch allocation of ``affinity_watershed_prep_config``, or the
  DoG twin) and reuses the engine's ``pipeline_cache`` across volumes.
  Labels are bit-identical to one-shot ``segment_data`` runs: the exact
  same processing functions and stores are used, only the config's
  lifetime changes. A JSON config's ``"device_flood"`` (``"pallas"``: the
  CUDA kernels; ``"xla"``, ``"exact"``, ``true``) and ``"flood_telemetry"``
  reach the pipelines as the keywords do.
- ``watch``: a filesystem watch loop — new ``*.zarr``/``*.zar`` stores or
  ``*.tif(f)`` files appearing in a directory are segmented into
  ``<output_dir>/<stem>.ome.zarr``; a ``<stem>.done`` marker records
  completion. A crashed run resumes for free: the marker is missing, and
  ``segmentation_loop``'s warm restart skips the frames already labelled
  on disk.

Driven by ``python -m iterseg_tpu_torch serve`` (cli.py).
"""
import os
import time

import numpy as np

__all__ = ["SegmentationServer", "watch", "scan_watch_dir"]


class SegmentationServer:
    """A warm segmenter: prep once, segment many volumes.

    ``segmenter``/``network_or_config_file`` follow ``segment_data``'s
    contract (checkpoint path, segmenter config JSON, or None for the
    bundled default U-Net). ``devices``: a list of ``torch.device``s
    (``None``: CUDA); a 4D volume's frames round-robin over them, and a 3D
    volume runs on the first.
    """

    def __init__(self, segmenter="affinity-unet-watershed",
                 network_or_config_file=None, chunk_size=(10, 256, 256),
                 margin=(1, 64, 64), devices=None):
        from . import segmentation as seg

        pairs = {
            "affinity-unet-watershed": (
                seg.affinity_watershed_for_chunks,
                seg.affinity_watershed_prep_config,
            ),
            "DoG-blob-watershed": (
                seg.dog_blob_watershed_for_chunks,
                seg.dog_blob_watershed_prep_config,
            ),
        }
        if segmenter not in pairs:
            raise ValueError(
                f"unknown segmenter {segmenter!r}; serving supports "
                f"{sorted(pairs)}"
            )
        self.segmenter = segmenter
        self.network_or_config_file = network_or_config_file
        self.chunk_size = tuple(chunk_size)
        self.margin = tuple(margin)
        self.devices = seg._devices(devices)
        self._fn, self._prep = pairs[segmenter]
        self._config = None

    def _config_for(self, layer):
        if self._config is None:
            self._config = self._prep(
                layer, self.network_or_config_file, None
            )
            self._config["devices"] = self.devices
        # per-volume scratch: resize the shared feature scratch when the
        # zyx shape changes — everything else (the model, the pipeline cache
        # and its built kernels) is deliberately shared across volumes
        ov = self._config.get("output_volume")
        zyx = tuple(layer.data.shape[-3:])
        if ov is not None and ov.shape[1:] != zyx:
            self._config["output_volume"] = np.zeros(
                (ov.shape[0],) + zyx, dtype=np.float32
            )
        return self._config

    def segment_to(self, data, save_path, name="labels"):
        """Segment one (t,)zyx array/zarr into an OME-Zarr labels store at
        ``save_path``; returns the zarr-backed labels (same store layout
        as ``segmentation_wrapper``, so outputs are drop-in)."""
        from . import segmentation as seg

        layer = seg._as_layer(data, name=name)
        config = self._config_for(layer)
        shape = tuple(layer.data.shape)
        output_labels = seg.allocate_labels_store(
            save_path, shape, self.chunk_size, name,
        )
        for t in seg.segmentation_loop(
            None, layer.data, self.chunk_size, self.margin, output_labels,
            self._fn, config,
        ):
            print(f"Segmented t = {t}", flush=True)
        return output_labels


def _store_ready(path):
    """A zarr store is servable once its array metadata exists — either a
    plain array root (``.zarray``) or an OME-Zarr group root whose level-0
    array is in place (``0/.zarray``)."""
    return (os.path.exists(os.path.join(path, ".zarray"))
            or os.path.exists(os.path.join(path, "0", ".zarray")))


def _marker_source(marker_path):
    """The input entry a ``.done`` marker recorded (its first line), or
    None for pre-source markers that held only the timing line."""
    try:
        with open(marker_path) as f:
            first = f.readline().strip()
    except OSError:
        return None
    if first.endswith("s"):
        try:
            float(first[:-1])
            return None  # legacy timing-only marker
        except ValueError:
            pass
    return first or None


def scan_watch_dir(watch_dir, output_dir):
    """Pending inputs: (input_path, stem, is_file) for every servable
    ``*.zarr``/``*.zar`` store (plain or OME root) or ``*.tif(f)`` file in
    ``watch_dir`` without a matching ``<stem>.done`` marker in
    ``output_dir``, oldest first.

    Markers record which input they belong to, so a store and a tiff
    sharing a base name ("vol.zarr" / "vol.tif") never shadow each other:
    the second source is deterministically served under ``<base>-<ext>``
    ("vol-tif") instead of being silently dropped."""
    entries = []
    for entry in sorted(os.listdir(watch_dir)):
        path = os.path.join(watch_dir, entry)
        if entry.endswith((".zarr", ".zar")) and os.path.isdir(path):
            if not _store_ready(path):
                continue  # still being created
            entries.append((path, entry, False))
        elif entry.endswith((".tif", ".tiff")) and os.path.isfile(path):
            entries.append((path, entry, True))
    pending, taken = [], set()
    for path, entry, is_file in entries:
        base, ext = entry.rsplit(".", 1)
        stem = base
        marker = os.path.join(output_dir, stem + ".done")
        src = _marker_source(marker) if os.path.exists(marker) else ()
        # base stem belongs to someone else (another pending entry, or a
        # marker recorded for a different source) -> deterministic alias
        if stem in taken or src not in ((), None, entry):
            stem = f"{base}-{ext}"
            marker = os.path.join(output_dir, stem + ".done")
        taken.add(stem)
        if not os.path.exists(marker):
            pending.append((path, stem, is_file))
    pending.sort(key=lambda item: os.path.getmtime(item[0]))
    return pending


def watch(watch_dir, output_dir, server, poll_seconds=5.0, once=False,
          max_volumes=None, pyramid_levels=0, errors=None):
    """Serve loop: segment every pending input in ``watch_dir`` into
    ``output_dir``, then poll for new arrivals (or return, with
    ``once=True``, after a single drain — the testable mode).

    Per input: labels land at ``<output_dir>/<stem>.ome.zarr`` and a
    ``<stem>.done`` marker records the source entry + timing (producers
    should write stores under a temporary name and rename them in).
    Failures are reported and retried on the next poll (no marker is
    written); pass ``errors=[]`` to also collect ``(path, exception)``
    pairs — the CLI uses this to exit nonzero on a failed ``--once``
    drain. Returns the list of stems segmented."""
    from ..widgets import read_data

    os.makedirs(str(output_dir), exist_ok=True)
    done = []
    while True:
        for path, stem, is_file in scan_watch_dir(watch_dir, output_dir):
            if max_volumes is not None and len(done) >= max_volumes:
                return done
            try:
                if is_file:
                    data, _ = read_data(None, path, "individual frames")
                else:
                    # zarr stays disk-backed: segmentation_loop reads one
                    # frame at a time, so RAM stays O(frame), not O(stack)
                    data, _ = read_data(path, None, "individual frames",
                                        in_memory=False)
                out_path = os.path.join(str(output_dir), stem + ".ome.zarr")
                t0 = time.time()
                server.segment_to(data, out_path, name=stem)
                if pyramid_levels:
                    from ..io.zarr_io import add_pyramid_levels

                    add_pyramid_levels(out_path, n_levels=pyramid_levels)
                with open(os.path.join(str(output_dir), stem + ".done"),
                          "w") as f:
                    f.write(f"{os.path.basename(path)}\n"
                            f"{time.time() - t0:.3f}s\n")
                print(f"served {stem} in {time.time() - t0:.2f}s -> "
                      f"{out_path}", flush=True)
                done.append(stem)
            except Exception as e:  # keep serving; retried next poll
                print(f"ERROR serving {path}: {e!r}", flush=True)
                if errors is not None:
                    errors.append((path, e))
        if once:
            return done
        if max_volumes is not None and len(done) >= max_volumes:
            return done
        time.sleep(poll_seconds)
