"""iterseg_tpu_torch: the PyTorch/CUDA port of iterseg_tpu.

The same module layout and public names as ``iterseg_tpu``, on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a). The port imports
``torch``, numpy and scipy, never ``jax`` and nothing of ``iterseg_tpu``.

Submodules are imported lazily, so ``import iterseg_tpu_torch`` is cheap and
builds no kernel: the CUDA flood kernels (``ops/flood_kernel``,
``ops/image_flood_kernel``) and the host C++ floods (``native``) compile on
first use into ``build/iterseg_tpu_torch``.

Entry points run on CUDA unless the caller passes a CPU device
(``device.resolve_device``): the segmenters, training (``train_unet``,
``run_experiment``), the widgets' headless twins and the CLI
(``python -m iterseg_tpu_torch``, ``--device cpu`` for the CPU).

Several devices and hosts live in ``iterseg_tpu_torch.parallel`` (``mesh``:
the data x space train step and chunk-batch inference; ``multihost``:
frames round-robined over processes on ``torch.distributed``), which the
top level does not re-export, as in JAX.

Every name of the JAX package's ``__all__`` is exported here, with
``generate_ground_truth`` as the same alias of ``ground_truth_from_ROI``
(the reference's ``__all__`` names a function it does not define).
"""
from __future__ import annotations

import importlib

__version__ = "0.1.0"

_WIDGETS = "iterseg_tpu_torch.widgets"

_LAZY = {
    "train_from_viewer": _WIDGETS,
    "_train_from_viewer": _WIDGETS,
    "load_data": _WIDGETS,
    "_load_data": _WIDGETS,
    "segment_data": _WIDGETS,
    "combine_layers": _WIDGETS,
    "assess_segmentation": _WIDGETS,
    "_assess_segmentation": _WIDGETS,
    "compare_segmentations": _WIDGETS,
    "save_frames": _WIDGETS,
    "ground_truth_from_ROI": _WIDGETS,
    "_ground_truth_from_ROI": _WIDGETS,
    "generate_ground_truth": _WIDGETS,
    "Viewer": "iterseg_tpu_torch.viewer",
    "UNetModel": "iterseg_tpu_torch.engine.predict",
    "segmenters": "iterseg_tpu_torch.engine.segmentation",
    "affinity_unet_watershed": "iterseg_tpu_torch.engine.segmentation",
    "dog_blob_watershed": "iterseg_tpu_torch.engine.segmentation",
    "unet_mask": "iterseg_tpu_torch.engine.segmentation",
    "otsu_mask": "iterseg_tpu_torch.engine.segmentation",
    "blob_watershed": "iterseg_tpu_torch.engine.segmentation",
    "load_unet": "iterseg_tpu_torch.engine.predict",
    "predict_volume": "iterseg_tpu_torch.engine.predict",
    "AffinityPipeline": "iterseg_tpu_torch.engine.device_pipeline",
    "DoGPipeline": "iterseg_tpu_torch.engine.device_pipeline",
    "resolve_device": "iterseg_tpu_torch.device",
    "train_unet": "iterseg_tpu_torch.train.train",
    "run_experiment": "iterseg_tpu_torch.train.experiments",
    "get_experiment_dict": "iterseg_tpu_torch.train.experiments",
}

# names exported under another module attribute
_ALIASES = {"generate_ground_truth": "ground_truth_from_ROI"}

__all__ = sorted(n for n in _LAZY if not n.startswith("_"))


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]),
                       _ALIASES.get(name, name))
    raise AttributeError(
        f"module 'iterseg_tpu_torch' has no attribute {name!r}")
