"""Segmenter registry and the batch-segmentation loop.

The port of ``iterseg_tpu/engine/segmentation.py``: for each segmenter a
(config prep, per-volume process) pair — ``affinity-unet-watershed`` and
``DoG-blob-watershed`` in the ``segmenters`` registry, and the working
``unet_mask``, ``otsu_mask`` and ``blob_watershed`` that stay out of it, as
in the reference — plus ``segmentation_wrapper`` (label store allocation,
the frame loop, the optional background worker), ``segmentation_loop``
with its warm restart (labelled frames of a 4D store are skipped) and
``segment_single_volume``. Signatures are the JAX package's; the
keyword-only ``devices`` takes a list of ``torch.device``s (``None`` means
CUDA): the frames of a 4D stack round-robin over it (frame parallelism,
labels equal to one device's), and a 3D volume runs on its first device.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
from types import SimpleNamespace
from typing import Callable, Union

import numpy as np

import torch

from ..core.volume import prepare_volume, restore_labels
from ..device import resolve_device
from ..io.zarr_io import save_labels_to_ome
from ..ops import watershed as ws
from ..ops.blob import blob_dog, blob_log
from ..ops.cc import label_np
from ..ops.edt import edt_np
from ..ops.filters import dog_image as _dog_image_t
from ..ops.filters import gaussian
from ..utils import call_span, carried, count, frame_span, span
from .device_pipeline import AffinityPipeline, DoGPipeline, _prepare_frame
from .predict import load_unet, predict_volume

__all__ = [
    "affinity_unet_watershed",
    "affinity_watershed_prep_config",
    "affinity_watershed_for_chunks",
    "dog_blob_watershed",
    "dog_blob_watershed_prep_config",
    "dog_blob_watershed_for_chunks",
    "dog_image",
    "unet_mask",
    "otsu_mask",
    "blob_watershed",
    "segmentation_wrapper",
    "SegmentationWorker",
    "segmentation_loop",
    "segment_single_volume",
    "allocate_labels_store",
    "read_config_json",
    "segmenters",
]


def _as_layer(obj, name="input"):
    """Accept napari-like layers or bare arrays (arrays first: an ndarray's
    ``.data`` is its raw buffer)."""
    if (
        hasattr(obj, "data")
        and not isinstance(obj, np.ndarray)
        and not isinstance(getattr(obj, "data"), memoryview)
    ):
        return obj
    data = obj
    return SimpleNamespace(
        data=data,
        scale=np.ones(getattr(data, "ndim", 3)),
        translate=np.zeros(getattr(data, "ndim", 3)),
        name=name,
        metadata={},
    )


def read_config_json(path_to_json):
    with open(path_to_json, "r") as f:
        return json.load(f)


def _config_or(config, key, default):
    """Missing or ``null`` falls back to the default; explicit falsy values
    are honoured."""
    value = config.get(key)
    return default if value is None else value


def _devices(devices):
    """The devices a run uses: ``None`` is ``[cuda]``; a list is resolved
    entry by entry (several entries may name one device)."""
    if devices is None:
        return [resolve_device(None)]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("devices must name at least one device")
    return devices


def _first_device(devices):
    """Where one volume runs: the first of ``devices`` (JAX runs a 3D
    volume on its default device whatever the list)."""
    return _devices(devices)[0]


def dog_image(input_vol, sigma_min, sigma_max, device=None):
    """Difference of Gaussians on ``device`` (CUDA by default), as numpy —
    parity: segmentation.py:678-680."""
    x = torch.as_tensor(np.asarray(input_vol), device=resolve_device(device))
    return _dog_image_t(x, sigma_min, sigma_max).cpu().numpy()


def _smoothed_np(image, sigma, device):
    """``gaussian(image, sigma)`` on ``device``, as numpy."""
    x = torch.as_tensor(np.ascontiguousarray(image), device=device)
    return gaussian(x, float(sigma)).cpu().numpy()


def affinity_watershed_prep_config(input_volume_layer, unet_or_config_file,
                                   reference_layer, compute_dtype=None,
                                   device_flood=None,
                                   flood_telemetry=None):
    """Resolve the U-Net source and allocate the scratch feature volume.

    ``unet_or_config_file``: a ``.npz``/``.pt`` checkpoint, a JSON config
    (``unet`` — a path, ``"labels layer"`` for the reference layer's
    ``metadata["unet"]``, or ``"default"`` — plus optional
    ``affinities_extent``, ``compute_dtype``, ``device_flood``,
    ``flood_telemetry``), or ``None`` for the bundled default checkpoint.
    ``compute_dtype="bfloat16"`` runs the forward in bf16. ``device_flood``
    (``AffinityPipeline.normalize_device_flood``): ``"pallas"`` floods on
    the GPU with the CUDA kernel and ``"xla"`` with the torch recurrence
    (both approximate), ``"exact"`` runs the verified flood (labels
    bit-equal to the default exact host flood), ``True`` picks by the
    measured link rate."""
    unet = None
    affinities_extent = 1
    if isinstance(unet_or_config_file, pathlib.PurePath):
        unet_or_config_file = str(unet_or_config_file)
    if isinstance(unet_or_config_file, str):
        if unet_or_config_file.endswith(".json"):
            config = read_config_json(unet_or_config_file)
            unet = config.get("unet")
            affinities_extent = _config_or(config, "affinities_extent", 1)
            if compute_dtype is None:
                compute_dtype = config.get("compute_dtype")
            if device_flood is None:
                device_flood = config.get("device_flood")
            if flood_telemetry is None:
                flood_telemetry = config.get("flood_telemetry")
            if unet == "labels layer":
                unet = reference_layer.metadata["unet"]
            if unet == "default":
                unet = None
        elif unet_or_config_file.endswith((".pt", ".pth", ".npz")):
            unet = unet_or_config_file
    if unet is not None:
        m = (
            f"There was no file at the provided location: {unet}\n"
            "Make sure a unet checkpoint lives here..."
        )
        assert os.path.exists(unet), m
    if compute_dtype is None:
        model = load_unet(unet)
    else:
        model = load_unet(unet, compute_dtype=compute_dtype)
    num_pred_channels = 3 * affinities_extent + 2
    data = input_volume_layer.data
    output_volume = np.zeros(
        (num_pred_channels,) + tuple(data.shape[-3:]), dtype=np.float32
    )
    return {"unet": model, "output_volume": output_volume,
            "pipeline_cache": {}, "device_flood": device_flood or False,
            "flood_telemetry": bool(flood_telemetry)}


def _host_normalised(volume, device_normalize):
    """With ``device_normalize`` the caller skipped host normalisation for
    the device pipeline's ``/ max``: it runs here (same arithmetic)."""
    if not device_normalize:
        return volume
    volume = np.asarray(volume).astype(np.float32)
    return volume / np.max(volume)


def affinity_watershed_for_chunks(
    input_volume,
    current_output,
    chunk_size,
    margin,
    unet=None,
    output_volume=None,
    pipeline_cache=None,
    use_device_pipeline=True,
    device_flood=False,
    flood_telemetry=False,
    device_normalize=False,
    profile=None,
    devices=None,
    **kwargs,
):
    """Per-volume process: chunked U-Net inference + affinity watershed.

    Default fast path: the device-resident ``AffinityPipeline``; labels are
    bit-identical to the generic ``predict_volume`` +
    ``segment_output_image`` path (``use_device_pipeline=False``)."""
    if unet is None:
        raise ValueError("unet must not be None")
    pipe = _device_pipeline(
        affinity_watershed_for_chunks, chunk_size, margin,
        pipeline_cache=pipeline_cache,
        use_device_pipeline=use_device_pipeline, device_flood=device_flood,
        devices=devices, unet=unet, output_volume=output_volume,
        flood_telemetry=flood_telemetry)
    if pipe is not None:
        pipe.segment(input_volume, out=current_output.ravel(),
                     profile=profile, normalize=bool(device_normalize))
        return
    device = _first_device(devices)
    if output_volume is None:
        raise ValueError("output_volume must not be None")
    input_volume = _host_normalised(input_volume, device_normalize)
    if output_volume.shape[1:] != input_volume.shape:
        # zero-slice removal shrank the frame
        output_volume = np.zeros(
            (output_volume.shape[0],) + input_volume.shape, dtype=np.float32
        )
    predict_volume(unet, input_volume, chunk_size=chunk_size, margin=margin,
                   output_volume=output_volume, device=device)
    ws.segment_output_image(
        output_volume,
        affinities_channels=(0, 1, 2),
        thresholding_channel=3,
        centroids_channel=4,
        out=current_output.ravel(),
        device=device,
    )
    output_volume[:] = 0


def affinity_unet_watershed(
    napari_viewer,
    input_volume_layer,
    save_dir: Union[str, None] = None,
    name: str = "my-segmentation",
    unet_or_config_file: Union[str, None] = None,
    layer_reference=None,
    chunk_size=(10, 256, 256),
    margin=(1, 64, 64),
    debug: bool = False,
    *,
    devices=None,
    compute_dtype=None,
    device_flood=None,
    flood_telemetry=None,
    threaded: bool = False,
):
    """Segment a 3D volume or 4D stack with the affinity U-Net watershed.

    The JAX package's signature. Keyword-only: ``devices`` — a list of
    ``torch.device``s a stack's frames round-robin over (``None``: CUDA);
    ``compute_dtype`` — e.g.
    ``"bfloat16"``; ``device_flood`` — ``"pallas"`` (the CUDA kernel) or
    ``"xla"`` (the torch recurrence) floods on the device, approximately,
    ``"exact"`` runs the verified flood (bit-equal labels), ``True`` picks
    by the measured link rate, ``False`` (default) runs the exact host
    flood; ``flood_telemetry`` — a rigorous per-run disagreement bound of
    the approximate floods in the profile, on volumes and stacks (JAX
    drops it on a stack); ``threaded`` —
    return a live :class:`SegmentationWorker` (ignored under ``debug``).
    """
    prep = affinity_watershed_prep_config
    if (compute_dtype is not None or device_flood is not None
            or flood_telemetry is not None):
        def prep(layer, unet_or_cfg, ref, _cd=compute_dtype,
                 _df=device_flood, _ft=flood_telemetry):
            return affinity_watershed_prep_config(
                layer, unet_or_cfg, ref, compute_dtype=_cd,
                device_flood=_df, flood_telemetry=_ft,
            )
    return segmentation_wrapper(
        affinity_watershed_for_chunks,
        prep,
        napari_viewer,
        input_volume_layer,
        save_dir,
        name,
        unet_or_config_file,
        layer_reference,
        chunk_size,
        margin,
        debug,
        threaded=threaded,
        devices=devices,
    )


# ---------------------------------------------------------------------------
# DoG blob watershed
# ---------------------------------------------------------------------------


def dog_blob_watershed_prep_config(
    input_volume_layer,
    unet_or_config_file,
    reference_layer,
    max_sigma=1.5,
    min_sigma=1,
    threshold=0.02,
    device_flood=None,
):
    """The DoG parameters from a JSON config (``max_sigma``, ``min_sigma``,
    ``threshold``, ``device_flood``) or the defaults; explicit falsy values
    (e.g. threshold 0) are honoured, only a missing or null key falls back.
    ``device_flood``: ``"pallas"`` (the CUDA image kernel) or ``"xla"``
    floods on the device, approximately; ``"exact"`` runs the verified
    image flood (bit-equal labels); the default is the exact host flood."""
    if unet_or_config_file is not None:
        config = read_config_json(str(unet_or_config_file))
        max_sigma = _config_or(config, "max_sigma", max_sigma)
        min_sigma = _config_or(config, "min_sigma", min_sigma)
        threshold = _config_or(config, "threshold", threshold)
        if device_flood is None:
            device_flood = config.get("device_flood")
    return {
        "max_sigma": max_sigma,
        "min_sigma": min_sigma,
        "threshold": threshold,
        "pipeline_cache": {},
        "device_flood": device_flood or False,
    }


def dog_blob_watershed_for_chunks(
    input_volume,
    current_output,
    chunk_size,
    margin,
    min_sigma,
    max_sigma,
    threshold,
    pipeline_cache=None,
    use_device_pipeline=True,
    device_flood=False,
    flood_telemetry=False,
    device_normalize=False,
    profile=None,
    devices=None,
    **kwargs,
):
    """Whole-volume DoG blob segmentation (parity: segmentation.py:592-650):
    pad by 1, DoG mask, ``blob_dog`` seed points, EDT-landscape watershed.
    The chunk grid is ignored, as in the reference.

    Default fast path: the device-resident ``DoGPipeline``; labels are
    bit-identical to the host path (``use_device_pipeline=False``).
    ``flood_telemetry`` is accepted for config uniformity and ignored, as
    in the JAX package (there is no image-flood certificate)."""
    pipe = _device_pipeline(
        dog_blob_watershed_for_chunks, chunk_size, margin,
        pipeline_cache=pipeline_cache,
        use_device_pipeline=use_device_pipeline, device_flood=device_flood,
        devices=devices, min_sigma=min_sigma, max_sigma=max_sigma,
        threshold=threshold)
    if pipe is not None:
        pipe.segment(input_volume, out=current_output, profile=profile,
                     normalize=bool(device_normalize))
        return
    device = _first_device(devices)
    input_volume = _host_normalised(input_volume, device_normalize)
    input_volume = np.pad(input_volume, pad_width=1)
    dog = dog_image(input_volume, min_sigma, max_sigma, device=device)
    mask = dog > threshold
    markers_blobs = blob_dog(input_volume, min_sigma=min_sigma,
                             max_sigma=max_sigma, threshold=threshold,
                             device=device)
    distance = edt_np(input_volume)
    centroids = np.zeros(distance.shape, dtype=bool)
    idx = tuple(markers_blobs.T.astype(int))[:-1]
    centroids[idx] = True
    markers, _ = label_np(centroids)
    labels = ws.image_watershed(-distance, markers, mask)
    current_output[:, ...] = labels


def dog_blob_watershed(
    napari_viewer,
    input_volume_layer,
    save_dir: Union[str, None] = None,
    name: str = "labels-prediction",
    config_file: Union[str, None] = None,
    layer_reference=None,
    chunk_size=(10, 256, 256),
    margin=(1, 64, 64),
    debug: bool = False,
    *,
    devices=None,
    device_flood=None,
    flood_telemetry=None,
    threaded: bool = False,
):
    """Classical DoG blob segmentation (no network) of a 3D volume or 4D
    stack. The JAX package's signature. Keyword-only: ``devices`` — a list
    of ``torch.device``s a stack's frames round-robin over (``None``:
    CUDA); ``device_flood`` — ``"pallas"``
    (the CUDA image kernel) or ``"xla"`` floods on the device
    (approximate, exact host fallback on non-convergence), ``"exact"`` runs
    the verified image flood (bit-equal labels), ``True`` picks by the
    measured link rate, ``False`` (default) runs the exact host
    flood; ``flood_telemetry`` — accepted and ignored, as in JAX;
    ``threaded`` — return a live :class:`SegmentationWorker`."""
    del flood_telemetry
    prep = dog_blob_watershed_prep_config
    if device_flood is not None:
        def prep(layer, cfg, ref, _df=device_flood):
            return dog_blob_watershed_prep_config(layer, cfg, ref,
                                                  device_flood=_df)
    return segmentation_wrapper(
        dog_blob_watershed_for_chunks,
        prep,
        napari_viewer,
        input_volume_layer,
        save_dir,
        name,
        config_file,
        layer_reference,
        chunk_size,
        margin,
        debug,
        threaded=threaded,
        devices=devices,
    )


# ---------------------------------------------------------------------------
# Auxiliary segmenters (working equivalents of the reference's disabled ones)
# ---------------------------------------------------------------------------


def unet_mask_for_chunks(input_volume, current_output, chunk_size, margin,
                         output_volume=None, unet=None, devices=None,
                         **kwargs):
    """U-Net mask channel only (reference's disabled unet-mask,
    segmentation.py:248-296, made functional)."""
    from ..ops.threshold import threshold_otsu_np

    device = _first_device(devices)
    if output_volume.shape[1:] != input_volume.shape:
        # zero-slice removal shrank the frame
        output_volume = np.zeros(
            (output_volume.shape[0],) + input_volume.shape, dtype=np.float32)
    predict_volume(unet, input_volume, chunk_size=chunk_size, margin=margin,
                   output_volume=output_volume, device=device)
    masking = output_volume[3]
    mask = masking > threshold_otsu_np(_smoothed_np(masking, 2.0, device))
    current_output[1:-1, 1:-1, 1:-1] = mask
    output_volume[:] = 0


def unet_mask(napari_viewer, input_volume_layer, save_dir=None,
              name="labels-prediction", unet_or_config_file=None,
              layer_reference=None, chunk_size=(10, 256, 256),
              margin=(1, 64, 64), debug=False, *, devices=None):
    return segmentation_wrapper(
        unet_mask_for_chunks, affinity_watershed_prep_config, napari_viewer,
        input_volume_layer, save_dir, name, unet_or_config_file,
        layer_reference, chunk_size, margin, debug, devices=devices,
    )


def otsu_mask_for_chunks(input_volume, current_output, chunk_size, margin,
                         gaus_sigma=2, devices=None, **kwargs):
    from ..ops.threshold import threshold_otsu_np

    smoothed = _smoothed_np(input_volume, gaus_sigma,
                            _first_device(devices))
    mask = input_volume > threshold_otsu_np(smoothed)
    current_output[1:-1, 1:-1, 1:-1] = mask


def otsu_mask_prep_config(input_volume_layer, config_file, layer_reference):
    """A JSON config may set ``gaus_sigma`` (default 2, the
    ``ws._get_mask`` sigma); the reference's version cannot be reached
    from the wrapper (segmentation.py:408-410)."""
    gaus_sigma = 2
    if config_file is not None:
        config = read_config_json(str(config_file))
        gaus_sigma = _config_or(config, "gaus_sigma", gaus_sigma)
    return {"gaus_sigma": gaus_sigma}


def otsu_mask(napari_viewer, input_volume_layer, save_dir=None,
              name="labels-prediction", config_file=None,
              layer_reference=None, chunk_size=(10, 256, 256),
              margin=(1, 64, 64), debug=False, *, devices=None):
    return segmentation_wrapper(
        otsu_mask_for_chunks, otsu_mask_prep_config, napari_viewer,
        input_volume_layer, save_dir, name, config_file, layer_reference,
        chunk_size, margin, debug, devices=devices,
    )


def blob_watershed_prep_config(
    input_volume_layer,
    unet_or_config_file,
    reference_layer,
    min_sigma=1,
    max_sigma=30,
    num_sigma=10,
    threshold=0.1,
    gaus_sigma=2,
):
    """The LoG parameters (the reference's defaults); a JSON config may
    override any of them, as in the DoG prep."""
    if unet_or_config_file is not None:
        config = read_config_json(str(unet_or_config_file))
        min_sigma = _config_or(config, "min_sigma", min_sigma)
        max_sigma = _config_or(config, "max_sigma", max_sigma)
        num_sigma = _config_or(config, "num_sigma", num_sigma)
        threshold = _config_or(config, "threshold", threshold)
        gaus_sigma = _config_or(config, "gaus_sigma", gaus_sigma)
    return {
        "min_sigma": min_sigma,
        "max_sigma": max_sigma,
        "num_sigma": num_sigma,
        "threshold": threshold,
        "gaus_sigma": gaus_sigma,
    }


def blob_watershed_for_chunks(
    input_volume,
    current_output,
    chunk_size,
    margin,
    min_sigma,
    max_sigma,
    num_sigma,
    threshold,
    gaus_sigma,
    devices=None,
    **kwargs,
):
    """LoG blob segmentation (the working twin of the reference's disabled
    ``blob_watershed_for_chunks``, segmentation.py:456-514): LoG scale
    space → labelled point seeds; EDT of the image as the landscape; mask
    = ``img > otsu(gaussian(img, gaus_sigma))``. Chunk grid ignored."""
    from ..ops.threshold import threshold_otsu_np

    device = _first_device(devices)
    markers_blobs = blob_log(
        input_volume, min_sigma=min_sigma, max_sigma=max_sigma,
        num_sigma=int(num_sigma), threshold=threshold, device=device,
    )
    smoothed = _smoothed_np(input_volume, gaus_sigma, device)
    mask = input_volume > threshold_otsu_np(smoothed)
    distance = edt_np(input_volume)
    centroids = np.zeros(distance.shape, dtype=bool)
    if len(markers_blobs):
        idx = tuple(markers_blobs[:, :input_volume.ndim].T.astype(int))
        centroids[idx] = True
    markers, _ = label_np(centroids)
    labels = ws.image_watershed(-distance, markers, mask)
    current_output[1:-1, 1:-1, 1:-1] = labels


def blob_watershed(
    napari_viewer,
    input_volume_layer,
    save_dir: Union[str, None] = None,
    name: str = "labels-prediction",
    config_file: Union[str, None] = None,
    layer_reference=None,
    chunk_size=(10, 256, 256),
    margin=(1, 64, 64),
    debug: bool = False,
    *,
    devices=None,
):
    """LoG blob watershed, kept out of the ``segmenters`` registry as in
    the reference but callable directly, like ``unet_mask`` and
    ``otsu_mask``."""
    return segmentation_wrapper(
        blob_watershed_for_chunks,
        blob_watershed_prep_config,
        napari_viewer,
        input_volume_layer,
        save_dir,
        name,
        config_file,
        layer_reference,
        chunk_size,
        margin,
        debug,
        devices=devices,
    )


def allocate_labels_store(save_path, shape, chunk_size, name,
                          scale=None, translate=None, dtype=np.int32):
    """The output labels store: OME-Zarr, chunked one frame / one
    chunk-size block."""
    layer_meta = {
        "scale": scale if scale is not None else np.ones(len(shape)),
        "translate": (translate if translate is not None
                      else np.zeros(len(shape))),
        "name": name,
    }
    return save_labels_to_ome(
        str(save_path), layer_meta=layer_meta, shape=tuple(shape),
        chunks=tuple(int(min(c, s)) for c, s in
                     zip((1,) * (len(shape) - 3) + tuple(chunk_size),
                         shape)),
        dtype=dtype,
    )


def segmentation_wrapper(
    processing_function: Callable,
    config_prep_function: Callable,
    napari_viewer,
    input_volume_layer,
    save_dir,
    name,
    network_or_config_file,
    layer_reference,
    chunk_size,
    margin,
    debug: bool = False,
    threaded: bool = False,
    devices=None,
):
    """Allocate the output label store, run the per-frame loop and (with a
    viewer) add the result layer. ``debug=True`` skips saving. The call is
    one ``call`` span (``utils.call_span``), its set-up up to the first
    frame the span ``entry``, the release of what it built the span
    ``release``."""
    with call_span():
        input_volume_layer = _as_layer(input_volume_layer)
        config = config_prep_function(
            input_volume_layer, network_or_config_file, layer_reference
        )
        if config is None:
            config = {}
        config["devices"] = _devices(devices)

        save_path = None
        if save_dir is not None and not debug:
            save_path = os.path.join(str(save_dir), name + ".ome.zarr")

        data = input_volume_layer.data
        shape = data.shape
        scale = getattr(input_volume_layer, "scale", np.ones(len(shape)))
        translate = getattr(input_volume_layer, "translate",
                            np.zeros(len(shape)))
        if save_path is not None:
            os.makedirs(str(save_dir), exist_ok=True)
            output_labels = allocate_labels_store(
                save_path, shape, chunk_size, name, scale=scale,
                translate=translate,
            )
        else:
            output_labels = np.zeros(shape, dtype=np.int32)

        loop = segmentation_loop(
            napari_viewer, data, chunk_size, margin, output_labels,
            processing_function, config,
        )

        def run():
            for t in loop:
                print(f"Segmented t = {t}")
            with span("release"):
                # the call's U-Net replicas and pipelines are freed here,
                # inside a span: a stack's replica blocks are marked for
                # its frame streams and record CUDA events as they go
                config.clear()

        def finish():
            if napari_viewer is not None:
                return napari_viewer.add_labels(
                    output_labels, name=name, scale=scale, translate=translate
                )
            return output_labels

        if threaded and not debug:
            return SegmentationWorker(run, finish)
        run()
        return finish()


class SegmentationWorker:
    """Handle to a segmentation running on a background thread.
    ``result()`` joins and returns what the synchronous path would have (or
    re-raises the worker's exception); ``done`` polls."""

    def __init__(self, run, finish):
        self._finish = finish
        self._error = None
        self._result_lock = threading.Lock()

        def target():
            try:
                run()
            except BaseException as e:  # re-raised in result()
                self._error = e

        self.thread = threading.Thread(target=carried(target), daemon=True)
        self.thread.start()

    @property
    def done(self) -> bool:
        return not self.thread.is_alive()

    def result(self, timeout=None):
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise TimeoutError("segmentation worker still running")
        if self._error is not None:
            raise self._error
        with self._result_lock:
            if not hasattr(self, "_result"):
                self._result = self._finish()
        return self._result


def _device_pipeline(segmenter, chunk_size, margin, pipeline_cache=None,
                     use_device_pipeline=True, device_flood=False,
                     devices=None, unet=None, output_volume=None,
                     flood_telemetry=False, min_sigma=None, max_sigma=None,
                     threshold=None, **_):
    """The device pipeline that serves ``segmenter`` (a ``*_for_chunks``
    function) under a config's keywords, from ``pipeline_cache``, or
    ``None`` where the host path runs: ``use_device_pipeline`` off, a
    segmenter with no pipeline, or an affinity config without a U-Net of
    the five channels. Pipelines are cached under their own resolved
    constructor arguments and built on the first of ``devices``."""
    if not use_device_pipeline:
        return None
    if segmenter is affinity_watershed_for_chunks:
        if unet is None or getattr(output_volume, "shape", (0,))[0] != 5:
            return None
        cls, args = AffinityPipeline, {
            "model": unet, "chunk_size": tuple(chunk_size),
            "margin": tuple(margin), "flood_telemetry": bool(flood_telemetry)}
    elif segmenter is dog_blob_watershed_for_chunks:
        cls, args = DoGPipeline, {"min_sigma": float(min_sigma),
                                  "max_sigma": float(max_sigma),
                                  "threshold": float(threshold)}
    else:
        return None
    args["device"] = _first_device(devices)
    args["device_flood"] = cls.normalize_device_flood(device_flood,
                                                      args["device"])
    cache = {} if pipeline_cache is None else pipeline_cache
    key = (cls,) + tuple(args.items())
    if key not in cache:
        count("pipelines")
        cache[key] = cls(**args)
    return cache[key]


def segmentation_loop(viewer, data, chunk_size, margin, output_labels,
                      processing_function, config):
    """Per-frame segmentation generator with warm restart: a 4D store's
    frames that already hold labels are skipped; a 3D volume is always
    segmented."""
    ndim = getattr(data, "ndim", len(data.shape))
    card = (config.get("devices") or [None])[0]  # for the frame spans
    if ndim == 3:
        frame = frame_span(0, card)
        with frame:
            output = segment_single_volume(
                np.asarray(data), chunk_size, config, margin,
                processing_function,
            )
            with span("restore"):
                output_labels[...] = output
        frame.close()
        yield 0
        return
    pipe = _device_pipeline(processing_function, chunk_size, margin,
                            **config)
    if pipe is not None:
        # pipelined 4D fast path: frame t+1's device work overlaps frame
        # t's host half, frames round-robin over ``devices`` (the labels
        # of the per-frame path on one device)
        yield from pipe.segment_stack(
            data, output_labels, devices=_devices(config.get("devices")))
        return
    for t in range(data.shape[0]):
        if np.any(np.asarray(output_labels[t])):
            continue  # warm restart: frame already segmented
        frame = frame_span(t, card)
        with frame:
            current_output = segment_single_volume(
                np.asarray(data[t]), chunk_size, config, margin,
                processing_function
            )
            with span("restore"):
                output_labels[t, ...] = current_output
        frame.close()
        yield t


def segment_single_volume(input_volume, chunk_size, config, margin,
                          processing_function):
    """Normalise, pad the output by one voxel, process, crop. Removed
    all-zero hyperplanes are scattered back as background. When a device
    pipeline (affinity or DoG) runs, integer volumes (itemsize <= 4) skip
    host normalisation and upload in their source dtype; the /max then runs
    on the device (bit-identical)."""
    raw = np.asarray(input_volume)
    original_shape = raw.shape
    cache = config.get("pipeline_cache")
    cache = {} if cache is None else cache  # the gate's build serves the call
    pipe = _device_pipeline(processing_function, chunk_size, margin,
                            **{**config, "pipeline_cache": cache})
    # the frame's preparation is part of its dispatch (a stack's frames
    # prepare inside the pipeline's own ``dispatch`` span)
    with span("dispatch"):
        if pipe is not None:
            input_volume, kept, device_normalize = _prepare_frame(raw)
            config = {**config, "pipeline_cache": cache,
                      "device_normalize": device_normalize}
        else:
            input_volume, kept = prepare_volume(raw.astype(np.float32),
                                                return_kept=True)
        current_output = np.pad(
            np.zeros(input_volume.shape, dtype=np.int32), 1, mode="constant",
        )
    crop = (slice(1, -1),) * current_output.ndim
    processing_function(input_volume, current_output, chunk_size, margin,
                        **config)
    with span("restore"):
        return restore_labels(current_output[crop], kept, original_shape)


segmenters = {
    "affinity-unet-watershed": affinity_unet_watershed,
    "DoG-blob-watershed": dog_blob_watershed,
}
