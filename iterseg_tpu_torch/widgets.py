"""Public entry points (the reference's widget layer, headless-first).

The port of ``iterseg_tpu/widgets.py``, on the port's segmenters, trainer
and metrics. The signatures are the JAX package's; ``segment_data`` also
takes the keyword-only ``devices`` of the segmenters, and the train twins
the keyword-only ``device`` of ``run_experiment`` (``None``: CUDA).

Every reference widget (iterseg ``_dock_widgets.py``) has its headless twin
here with an identical signature; the GUI layer (``gui.py``) wraps these in
``magic_factory`` factories with the reference's typed-control option dicts
(choices, ``FileEdit``, ``LiteralEvalLineEdit``), and ``napari.yaml``'s
widget commands resolve there.

Widgets: ``train_from_viewer``, ``load_data``, ``segment_data``,
``combine_layers``, ``assess_segmentation``, ``compare_segmentations``,
``save_frames``, ``ground_truth_from_ROI`` — plus their underscore twins
used by the examples (``_train_from_viewer``, ``_load_data``,
``_assess_segmentation``, ``_ground_truth_from_ROI``).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Union

import numpy as np

from .core.chunks import get_slices_from_chunks
from .engine.segmentation import segmenters
from .eval.metrics import get_accuracy_metrics, plot_accuracy_metrics
from .eval.plots import comparison_plots
from .io.zarr_io import zarr_save, zarr_open
from .train.experiments import get_experiment_dict, run_experiment
from .viewer import (
    Viewer,
    is_image_layer,
    is_labels_layer,
    is_points_layer,
    is_shapes_layer,
)

__all__ = [
    "train_from_viewer",
    "_train_from_viewer",
    "construct_channels_list",
    "construct_conditions_list",
    "load_data",
    "_load_data",
    "read_data",
    "correct_shape",
    "segment_data",
    "combine_layers",
    "assess_segmentation",
    "_assess_segmentation",
    "model_assessment",
    "get_slices_from_chunks",
    "compare_segmentations",
    "save_frames",
    "load_saved_data",
    "ground_truth_from_ROI",
    "_ground_truth_from_ROI",
    "find_matching_labels",
]


# ---------------------------------------------------------------------------
# Train widget (parity: _dock_widgets.py:37-227)
# ---------------------------------------------------------------------------


def _train_from_viewer(
    viewer,
    image_stack,
    labels_stack,
    output_dir: Union[str, None] = None,
    scale: tuple = (1, 1, 1),
    mask_prediction="mask",
    centre_prediciton="centreness-log",
    affinities_extent=1,
    training_name="my-unet",
    loss_function="BCELoss",
    learning_rate=0.01,
    epochs=4,
    validation_prop=0.2,
    n_each=50,
    predict_labels: bool = True,
    save_labels: bool = True,
    chunk_size=(10, 256, 256),
    margin=(1, 64, 64),
    train_shape=None,
    *,
    device=None,
):
    """Train a U-Net from stacked image + GT layers, optionally predicting
    full labels with the freshly trained network and recording metadata.

    ``train_shape``: keyword-only extension — the random-crop shape for
    training data. The reference widget fixes (10, 256, 256) (the
    ``get_train_data`` default, train_io.py:22); pass a smaller shape to
    train on volumes the fixed crop would not fit. ``None`` keeps
    reference behaviour. ``device``: where training and the prediction run
    (``None``: CUDA)."""
    from .engine.segmentation import _as_layer

    image_4D_stack = _as_layer(image_stack).data
    labels_4D_stack = _as_layer(labels_stack).data
    image_4D_stack = np.squeeze(np.asarray(image_4D_stack))
    labels_4D_stack = np.squeeze(np.asarray(labels_4D_stack))
    assert image_4D_stack.shape == labels_4D_stack.shape
    if image_4D_stack.ndim == 3:
        image_4D_stack = image_4D_stack[np.newaxis]
        labels_4D_stack = labels_4D_stack[np.newaxis]
    condition_name = [training_name]
    image_list = [image_4D_stack[i] for i in range(image_4D_stack.shape[0])]
    labels_list = [labels_4D_stack[i]
                   for i in range(labels_4D_stack.shape[0])]

    channels_list = construct_channels_list(
        affinities_extent, mask_prediction, centre_prediciton
    )
    conditions_list = construct_conditions_list(
        image_list, loss_function, learning_rate, epochs, scale
    )
    exp_dict = get_experiment_dict(
        channels_list, condition_name, conditions_list=conditions_list,
        validation_prop=validation_prop, n_each=n_each,
    )
    if train_shape is not None:
        exp_dict["get_train_data"]["shape"] = tuple(train_shape)
    u_path = run_experiment(exp_dict, image_list, labels_list, output_dir,
                            device=device)

    labels_layer = None
    save_path = None
    if predict_labels:
        if save_labels:
            save_path = os.path.join(
                str(output_dir), training_name + "_labels-prediction.zarr"
            )
        seg_func = segmenters["affinity-unet-watershed"]
        result = seg_func(
            napari_viewer=viewer, input_volume_layer=image_stack,
            save_dir=output_dir if save_labels else None,
            name=f"{training_name}_labels", unet_or_config_file=u_path[0],
            layer_reference=None, chunk_size=chunk_size, margin=margin,
            debug=False, devices=None if device is None else [device],
        )
        if viewer is not None:
            labels_layer = viewer.layers[f"{training_name}_labels"]
    meta = {
        "unet": u_path[0],
        "chunk_size": tuple(chunk_size),
        "margin": tuple(margin),
        "mask_prediction": mask_prediction,
        "centre_prediction": centre_prediciton,
        "affinities_extent": affinities_extent,
        "loss_function": loss_function,
        "output_dir": str(output_dir),
        "learning_rate": learning_rate,
        "epochs": epochs,
        "validation_prop": validation_prop,
        "n_each": n_each,
        "labels_path": save_path,
    }
    if labels_layer is not None:
        labels_layer.metadata.update(meta)
    meta_path = os.path.join(
        str(output_dir), Path(u_path[0]).stem + "_meta.json"
    )
    with open(meta_path, "w") as outfile:
        outfile.write(json.dumps(meta, indent=4))
    return u_path


def train_from_viewer(
    viewer,
    image_stack,
    labels_stack,
    output_dir: Union[str, None] = None,
    scale: tuple = (1, 1, 1),
    mask_prediction="mask",
    centre_prediciton="centreness-log",
    affinities_extent=1,
    training_name="my-unet",
    loss_function="BCELoss",
    learning_rate=0.01,
    epochs=4,
    validation_prop=0.2,
    n_each=50,
    predict_labels: bool = True,
    save_labels=True,
    *,
    device=None,
):
    """Widget twin (parity: _dock_widgets.py:37-79)."""
    return _train_from_viewer(
        viewer, image_stack, labels_stack, output_dir, scale,
        mask_prediction, centre_prediciton, affinities_extent,
        training_name, loss_function, learning_rate, epochs,
        validation_prop, n_each, predict_labels, save_labels,
        device=device,
    )


def _per_axis_extent(affinities_extent, dims):
    """Validated per-axis affinity extents: the widget accepts a scalar
    (broadcast to every axis) or a per-axis tuple.  The assertion /
    TypeError strings are part of the widget-behavior parity contract."""
    if isinstance(affinities_extent, tuple):
        assert len(affinities_extent) == len(dims), (
            "please ensure the length of the affinities extent tuple "
            f"matches the number of dims in {dims}"
        )
        return affinities_extent
    if isinstance(affinities_extent, int):
        return (affinities_extent,) * len(dims)
    raise TypeError(
        "Please insert affinities extent of type tuple or int "
        "(e.g., 1 or (2, 2, 1))"
    )


def construct_channels_list(affinities_extent, mask_prediction,
                            centre_predicition):
    """The one training-channels tuple — ``('z-1', …, 'x-1', mask,
    centre)`` — the widget's options denote (behavior parity:
    _dock_widgets.py:186-209; the channel-name grammar is
    ``train/train_io``'s input contract)."""
    dims = ("z", "y", "x")
    affinity_names = [
        f"{d}-{n}"
        for d, extent in zip(dims, _per_axis_extent(affinities_extent,
                                                    dims))
        for n in range(1, extent + 1)
    ]
    return [tuple(affinity_names + [mask_prediction, centre_predicition])]


def construct_conditions_list(image_list, loss_function, learning_rate,
                              epochs, scale):
    """(parity: _dock_widgets.py:212-226)."""
    return [{
        "scale": [scale for _ in image_list],
        "lr": learning_rate,
        "loss_function": loss_function,
        "epochs": epochs,
    }]


# ---------------------------------------------------------------------------
# Load data (parity: _dock_widgets.py:242-529)
# ---------------------------------------------------------------------------


def _load_data(
    napari_viewer,
    layer_name: str,
    layer_type: str = "Image",
    data_type: str = "individual frames",
    directory: Union[str, None] = None,
    data_file: Union[str, None] = None,
    scale: tuple = (1, 1, 1),
    translate: tuple = (0, 0, 0),
    split_channels: bool = False,
    in_memory: bool = True,
):
    """Load tiff/zarr data as stacked 3D frames into the viewer."""
    if napari_viewer is None:
        napari_viewer = Viewer()
    if directory is not None:
        directory = str(directory)
    if data_file is not None:
        data_file = str(data_file)
    if layer_type in ("Image", "Labels"):
        imgs, uses_directory = read_data(directory, data_file, data_type,
                                         in_memory)
        scale = tuple(scale)
        translate = tuple(translate)
        if getattr(imgs, "ndim", 3) > 3:
            extra = imgs.ndim - (4 if split_channels else 3)
            scale = (1,) * extra + scale
            translate = (0,) * extra + translate
        if layer_type == "Image":
            if not split_channels:
                napari_viewer.add_image(imgs, scale=scale, name=layer_name,
                                        translate=translate)
            else:
                channel_axis = int(np.argmin(imgs.shape))
                arr = np.asarray(imgs)  # once, not per channel
                for channel in range(imgs.shape[channel_axis]):
                    sl = [slice(None)] * imgs.ndim
                    sl[channel_axis] = channel
                    napari_viewer.add_image(
                        arr[tuple(sl)], scale=scale,
                        translate=translate,
                        name=f"{layer_name}-ch{channel}",
                    )
        if layer_type == "Labels":
            napari_viewer.add_labels(imgs, scale=scale, name=layer_name,
                                     translate=translate)
    if layer_type == "Shapes":
        if data_file is not None:
            shapes = read_shapes(data_file)
        elif directory is not None:
            files = [
                os.path.join(directory, f) for f in os.listdir(directory)
                if f.endswith(".npy")
            ]
            shapes = []
            for f in files:
                shapes = shapes + read_shapes(f)
        else:
            raise ValueError(
                "Please ensure you pick a file or directory to read from"
            )
        napari_viewer.add_shapes(shapes, scale=scale, name=layer_name,
                                 translate=translate)
    return napari_viewer


def load_data(
    napari_viewer,
    layer_name: str,
    layer_type: str = "Image",
    data_type: str = "individual frames",
    directory: Union[str, None] = None,
    data_file: Union[str, None] = None,
    scale: tuple = (1, 1, 1),
    translate: tuple = (0, 0, 0),
    split_channels: bool = False,
    in_memory: bool = True,
):
    """Widget twin (parity: _dock_widgets.py:242-296)."""
    return _load_data(napari_viewer, layer_name, layer_type, data_type,
                      directory, data_file, scale, translate,
                      split_channels, in_memory)


def read_shapes(data_file):
    shapes = np.load(str(data_file), allow_pickle=False)
    return [s for s in shapes]


def read_data(directory, data_file, data_type, in_memory=True):
    """Open zarr dirs / tiff files / directories of either as stacked
    frames (parity: _dock_widgets.py:397-509, with the broken dask-lazy
    path replaced by ``helpers.LazyImageStack``)."""
    from .helpers import LazyImageStack, _read_any

    possible_suf = [".zarr", ".zar", ".tiff", ".tif"]
    uses_directory = directory is not None
    is_zarr = False
    data_paths = []
    if uses_directory:
        uses_directory = (
            os.path.isdir(directory)
            and not directory.endswith((".zarr", ".zar"))
        )
    single_file = data_file is not None
    if single_file:
        if data_file.endswith((".tiff", ".tif")):
            data_paths = [data_file]
        elif data_file.endswith((".zarr", ".zar")):
            raise ValueError(
                f"zarr stores load via directory=, not data_file=: "
                f"{data_file!r}"
            )
        else:
            raise ValueError(
                f"data_file must be a .tif/.tiff file, got {data_file!r}"
            )
    elif not uses_directory:
        is_zarr = directory.endswith((".zarr", ".zar"))
    else:
        for f in sorted(os.listdir(directory)):
            if any(f.endswith(s) for s in possible_suf):
                data_paths.append(os.path.join(directory, f))
    if is_zarr:
        imgs = zarr_open(directory)
        if in_memory:
            imgs = np.asarray(imgs)
        return imgs, uses_directory
    if not data_paths:
        raise ValueError(
            f"no .tif/.tiff/.zarr files found under {directory!r}"
        )
    data_paths = sorted(data_paths)
    if (uses_directory and not in_memory
            and not (data_type == "image stacks" and len(data_paths) > 1)):
        # lazy frame stack; t-concatenated "image stacks" can't be
        # represented as one lazy frame-per-file view, so that mode falls
        # through to the eager path (same shape contract either way)
        imgs = LazyImageStack(data_paths)
        return imgs, uses_directory
    imgs = [np.squeeze(_read_any(p)) for p in data_paths]
    imgs = correct_shape(imgs)
    if uses_directory:
        if data_type == "image stacks" and len(imgs) > 1:
            imgs = np.concatenate(imgs)
        else:
            imgs = np.stack(imgs)
    else:
        imgs = imgs[0]
    return imgs, uses_directory


def correct_shape(imgs):
    """Zero-pad ragged frames to a common 3D shape
    (parity: _dock_widgets.py:513-529)."""
    imgs = [np.squeeze(img) for img in imgs]
    shapes_3D = np.array([im.shape[-3:] for im in imgs])
    shape_3D = np.max(shapes_3D, axis=0)
    not_max_size = [tuple(s) != tuple(shape_3D) for s in shapes_3D]
    if np.sum(not_max_size) > 0:
        final_imgs = []
        for im in imgs:
            final_shape = list(im.shape[:-3]) + list(shape_3D)
            new = np.zeros(final_shape, dtype=imgs[0].dtype)
            new[tuple(slice(0, s) for s in im.shape)] = im
            final_imgs.append(new)
        return final_imgs
    return imgs


# ---------------------------------------------------------------------------
# Segment widget (parity: _dock_widgets.py:544-612)
# ---------------------------------------------------------------------------


def segment_data(
    napari_viewer,
    input_volume_layer,
    save_dir: Union[str, None] = None,
    name: str = "labels-prediction",
    segmenter: str = "affinity-unet-watershed",
    network_or_config_file: Union[str, None] = None,
    layer_reference: Union[str, None] = None,
    chunk_size: tuple = (10, 256, 256),
    margin: tuple = (1, 64, 64),
    debug: bool = True,
    *,
    devices=None,
):
    """Dispatch to a registered segmenter (identical signature to the
    reference widget incl. its debug=True default); ``devices`` goes to the
    segmenter (a list of ``torch.device``s a stack's frames round-robin
    over; ``None``: CUDA)."""
    seg_func = segmenters[segmenter]
    return seg_func(napari_viewer, input_volume_layer, save_dir, name,
                    network_or_config_file, layer_reference, chunk_size,
                    margin, debug, devices=devices)


# ---------------------------------------------------------------------------
# Combine layers (parity: _dock_widgets.py:620-680)
# ---------------------------------------------------------------------------


def combine_layers(
    napari_viewer,
    base_layer,
    to_append,
    save_dir: Union[str, None] = None,
    save_prefix: str = "",
    save_all: bool = True,
    save_indivdually: bool = False,
    number_from: int = 0,
):
    """Concatenate a labels/image stack onto another, optionally saving."""
    base_layer.data = np.concatenate(
        [np.asarray(base_layer.data), np.asarray(to_append.data)]
    )
    if save_dir is not None:
        target = to_append.data if not save_all else base_layer.data
        target = np.asarray(target)
        if not save_indivdually:
            zarr_save(os.path.join(str(save_dir), save_prefix + ".zarr"),
                      target)
        else:
            for t in range(target.shape[0]):
                zarr_save(
                    os.path.join(str(save_dir),
                                 save_prefix + f"_{t + number_from}.zarr"),
                    target[t],
                )
    return base_layer


# ---------------------------------------------------------------------------
# Assessment (parity: _dock_widgets.py:701-888)
# ---------------------------------------------------------------------------


def _assess_segmentation(
    ground_truth,
    model_segmentation,
    chunk_size: tuple = (10, 256, 256),
    margin: tuple = (1, 64, 64),
    variation_of_information: bool = True,
    average_precision: bool = True,
    object_count: bool = True,
    save_dir: str = "choose directory",
    save_prefix: str = "segmentation-metrics",
    name: Union[str, None] = None,
    show: bool = True,
    exclude_chunks_less_than: int = 10,
):
    """Chunkwise VI/AP/count assessment with CSVs + plots."""
    from .engine.segmentation import _as_layer

    if name is None:
        name = save_prefix
    # deviation (reference bug, _dock_widgets.py:800-810): the magicgui
    # placeholder 'choose directory' must fail fast like None — the
    # reference creates a literal './choose directory' output dir
    assert save_dir is not None and str(save_dir) != "choose directory", (
        "Please pick a directory to which to save the data."
    )
    os.makedirs(str(save_dir), exist_ok=True)
    shape = tuple(_as_layer(model_segmentation).data.shape)
    slices = get_slices_from_chunks(shape, chunk_size, margin)
    data, stats = model_assessment(
        ground_truth, model_segmentation, save_prefix, name, slices,
        str(save_dir), variation_of_information, average_precision,
        object_count, exclude_chunks_less_than,
    )
    plot_accuracy_metrics(
        data, save_prefix, str(save_dir), name, variation_of_information,
        average_precision, object_count, show,
    )
    return data, stats


def assess_segmentation(
    napari_viewer,
    ground_truth,
    model_segmentation,
    chunk_size: tuple = (10, 256, 256),
    margin: tuple = (1, 64, 64),
    variation_of_information: bool = True,
    average_precision: bool = True,
    object_count: bool = True,
    save_dir: Union[str, None] = None,
    save_prefix: str = "segmentation-metrics",
    name: Union[str, None] = None,
    show: bool = True,
    exclude_chunks_less_than: int = 10,
):
    """Widget twin (parity: _dock_widgets.py:701-782)."""
    return _assess_segmentation(
        ground_truth, model_segmentation, chunk_size, margin,
        variation_of_information, average_precision, object_count,
        save_dir, save_prefix, name, show, exclude_chunks_less_than,
    )


def model_assessment(
    ground_truth,
    model_segmentation,
    save_prefix: str,
    name: str,
    slices: list,
    save_dir: str,
    variation_of_information: bool,
    average_precision: bool,
    object_count: bool,
    exclude_chunks_less_than: int,
):
    os.makedirs(save_dir, exist_ok=True)
    return get_accuracy_metrics(
        slices, ground_truth, model_segmentation, name, save_prefix,
        variation_of_information, average_precision, object_count,
        save_dir, exclude_chunks_less_than,
    )


# ---------------------------------------------------------------------------
# Comparison (parity: _dock_widgets.py:903-1049)
# ---------------------------------------------------------------------------


def compare_segmentations(
    comparison_directory: str,
    save_name: str,
    file_exstention: str = "pdf",
    output_directory: Union[str, None] = None,
    variation_of_information: bool = True,
    object_difference: bool = True,
    average_precision: bool = True,
    n_rows: int = 2,
    n_col: int = 2,
    comparison_name: str = "Model comparison",
    VI_indexs: tuple = (0, 1),
    OD_index: int = 2,
    AP_index: int = 3,
    fig_size: tuple = (7, 6),
    palette: str = "Set2",
    top_white_space: float = 5,
    left_white_space: float = 15,
    right_white_space: float = 5,
    bottom_white_space: float = 10,
    horizontal_white_space: float = 40,
    vertical_white_space: float = 40,
    font_size: int = 30,
    style: str = "ticks",
    context: str = "paper",
    show: bool = True,
):
    """Collated multi-model comparison figure."""
    return comparison_plots(
        comparison_directory, save_name, file_exstention, output_directory,
        variation_of_information, object_difference, average_precision,
        n_rows, n_col, comparison_name, VI_indexs, OD_index, AP_index,
        fig_size, "h", 0.2, palette, top_white_space, left_white_space,
        right_white_space, bottom_white_space, horizontal_white_space,
        vertical_white_space, font_size, style, context, show,
    )


# ---------------------------------------------------------------------------
# Save frames (parity: _dock_widgets.py:1060-1156)
# ---------------------------------------------------------------------------


def save_frames(
    napari_viewer,
    layer,
    save_dir: Union[str, None] = None,
    save_name: Union[str, None] = None,
    frames: Union[tuple, int, None] = None,
    save_as_stack: bool = True,
    load_saved: bool = False,
    load_name: Union[str, None] = None,
):
    """Save selected frames of a layer (zarr for image/labels, npy for
    shapes/points). The reference's ``for f in layer.data.shape[0]`` bug
    (_dock_widgets.py:1116) is fixed with a range."""
    if isinstance(frames, int):
        frames = (frames,)
    sp = None
    if is_image_layer(layer) or is_labels_layer(layer):
        if isinstance(frames, tuple):
            slices = [slice(f, f + 1) for f in frames]
            data = [np.asarray(layer.data[s]) for s in slices]
            if save_as_stack:
                data = np.squeeze(np.stack(data))
                sp = os.path.join(str(save_dir), save_name + ".zarr")
                zarr_save(sp, data)
            else:
                for f, d in zip(frames, data):
                    sp = os.path.join(str(save_dir),
                                      f"{save_name}_f{f}.zarr")
                    zarr_save(sp, d)
        if frames is None:
            if save_as_stack:
                sp = os.path.join(str(save_dir), save_name + ".zarr")
                zarr_save(sp, np.squeeze(np.asarray(layer.data)))
            else:
                for f in range(np.asarray(layer.data).shape[0]):
                    sp = os.path.join(str(save_dir),
                                      f"{save_name}_f{f}.zarr")
                    zarr_save(sp, np.asarray(layer.data[f]))
    elif is_shapes_layer(layer):
        data = np.stack(layer.data)
        sp = os.path.join(str(save_dir), save_name + ".npy")
        np.save(sp, data, allow_pickle=False)
    elif is_points_layer(layer):
        sp = os.path.join(str(save_dir), save_name + ".npy")
        np.save(sp, np.asarray(layer.data), allow_pickle=False)
    load_saved_data(load_saved, napari_viewer, frames, layer, sp, load_name)
    return sp


def load_saved_data(load_saved, napari_viewer, frames, layer, sp,
                    load_name):
    if not load_saved:
        return
    if is_image_layer(layer) or is_labels_layer(layer):
        loaded = zarr_open(sp)
    else:
        loaded = np.load(sp, allow_pickle=False)
    if load_name is None:
        fstr = "-".join(str(f) for f in (frames or ()))
        load_name = f"{layer.name}_f{fstr}"
    if layer.ndim != loaded.ndim:
        diff = layer.ndim - loaded.ndim
        scale = layer.scale[diff - layer.ndim:]
    else:
        scale = layer.scale
    if is_image_layer(layer):
        napari_viewer.add_image(loaded, name=load_name, scale=scale)
    elif is_labels_layer(layer):
        napari_viewer.add_labels(loaded, name=load_name, scale=scale)
    elif is_shapes_layer(layer):
        napari_viewer.add_shapes(loaded, name=load_name, scale=scale)
    elif is_points_layer(layer):
        napari_viewer.add_points(loaded, name=load_name, scale=scale)


# ---------------------------------------------------------------------------
# Ground truth from ROI (parity: _dock_widgets.py:1167-1329)
# ---------------------------------------------------------------------------


def _ground_truth_from_ROI(
    napari_viewer,
    image_layer,
    labels_layer,
    shapes_layer,
    save_dir: Union[str, None] = None,
    name: str = "gt-from-ROI",
    number_of_tiles: int = 1,
    padding: int = 2,
):
    """Tile proofread rectangular ROIs into fresh GT frames (the iterative
    data flywheel). xy rectangles, full z extent; image background filled
    with N(mean) noise. Behaviour parity: _dock_widgets.py:1211-1330
    (tile grid pitch = roi size + padding, row-major placement from the
    frame origin, one output frame per ROI).

    Deviation (fix, see PARITY.md): for >=5D layers the reference builds
    its leading-axis slices with a ``* extra_dims`` list-multiply
    (_dock_widgets.py:1240) that duplicates them and raises IndexError;
    ``roi_slice`` below indexes each leading axis once, so 5D+ inputs
    work. <=4D behaviour is identical.
    """

    def roi_slice(roi, ndim):
        """Full-z slice bounded by the ROI rectangle in xy (and in any
        leading stack axes the shape coordinates carry)."""
        lo = np.round(np.min(roi, axis=0)).astype(int)
        hi = np.round(np.max(roi, axis=0)).astype(int) + 1
        lead = tuple(slice(lo[i], hi[i]) for i in range(ndim - 3))
        xy = tuple(slice(lo[i], hi[i]) for i in (ndim - 2, ndim - 1))
        return lead + (slice(None),) + xy

    def tile_grid(frame_hw, tile_hw, n_tiles):
        """Row-major tile placements at pitch (tile + padding), capped by
        how many whole tiles fit in the frame."""
        cells_y, cells_x = (
            int(f // (t + padding)) for f, t in zip(frame_hw, tile_hw)
        )
        h, w = tile_hw
        placements = []
        for j in range(min(cells_y * cells_x, n_tiles)):
            row, col = divmod(j, cells_x)
            y0 = (h + padding) * row
            x0 = (w + padding) * col
            placements.append(
                (slice(None), slice(y0, y0 + h), slice(x0, x0 + w))
            )
        return placements

    gt = np.asarray(labels_layer.data)
    img = np.asarray(image_layer.data)
    frame_shape = gt.shape[-3:]
    gt_frames, im_frames = [], []
    for roi in shapes_layer.data:
        sl = roi_slice(roi, gt.ndim)
        gt_roi, im_roi = gt[sl], img[sl]
        gt_frame = np.zeros(frame_shape, dtype=gt.dtype)
        # numpy's global generator, as in the JAX package: after the same
        # np.random.seed both give the same background, bit for bit
        im_frame = np.random.normal(img.mean(), size=frame_shape)
        for t_ in tile_grid(gt.shape[-2:], gt_roi.shape[-2:],
                            number_of_tiles):
            gt_frame[t_] = gt_roi
            im_frame[t_] = im_roi
        gt_frames.append(gt_frame)
        im_frames.append(im_frame)
    final_gt_data = np.squeeze(np.stack(gt_frames))
    final_im_data = np.squeeze(np.stack(im_frames))
    if save_dir is not None:
        sp_l = os.path.join(str(save_dir), name + "_labels.zarr")
        zarr_save(sp_l, final_gt_data)
        sp_i = os.path.join(str(save_dir), name + "_img.zarr")
        zarr_save(sp_i, final_im_data)
        final_gt_data = zarr_open(sp_l)
        final_im_data = zarr_open(sp_i)
    if napari_viewer is not None:
        napari_viewer.add_image(
            final_im_data, scale=labels_layer.scale,
            translate=labels_layer.translate, name=name + "_img",
        )
        napari_viewer.add_labels(
            final_gt_data, scale=labels_layer.scale,
            translate=labels_layer.translate, name=name + "_labels",
        )
    return final_im_data, final_gt_data


def ground_truth_from_ROI(
    napari_viewer,
    image_layer,
    labels_layer,
    shapes_layer,
    save_dir: Union[str, None] = None,
    name: str = "gt-from-ROI",
    number_of_tiles: int = 1,
    padding: int = 2,
):
    """Widget twin (parity: _dock_widgets.py:1167-1208)."""
    return _ground_truth_from_ROI(
        napari_viewer, image_layer, labels_layer, shapes_layer, save_dir,
        name, number_of_tiles, padding,
    )


# ---------------------------------------------------------------------------
# Helpers (parity: _dock_widgets.py:1336-1350)
# ---------------------------------------------------------------------------


def find_matching_labels(napari_viewer, labels):
    """The viewer labels-layer whose data agrees with ``labels`` on
    every foreground voxel; first match wins, with the reference's
    duplicate warning (behavior parity: _dock_widgets.py:1336-1352,
    including the all-background ValueError from the empty reduction)."""
    foreground = np.where(labels > 0)
    wanted = labels[foreground]
    matching = [
        layer
        for layer in napari_viewer.layers
        if is_labels_layer(layer)
        and bool((np.asarray(layer.data)[foreground] == wanted).min())
    ]
    if len(matching) > 1:
        print("multiple identical labels found... using the first...")
    return matching[0]
