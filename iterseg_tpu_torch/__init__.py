"""iterseg_tpu_torch: the PyTorch/CUDA port of iterseg_tpu.

The same module layout and public names as ``iterseg_tpu``, on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a). The port imports
``torch``, numpy and scipy, never ``jax`` and nothing of ``iterseg_tpu``.

Submodules are imported lazily, so ``import iterseg_tpu_torch`` is cheap and
builds no kernel: the CUDA flood kernels (``ops/flood_kernel``,
``ops/image_flood_kernel``) and the host C++ floods (``native``) compile on
first use into ``build/iterseg_tpu_torch``.

Entry points run on CUDA unless the caller passes a CPU device
(``device.resolve_device``): the segmenters, and training
(``train_unet``, ``run_experiment``).
"""
from __future__ import annotations

import importlib

__version__ = "0.1.0"

_LAZY = {
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

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'iterseg_tpu_torch' has no attribute {name!r}")
